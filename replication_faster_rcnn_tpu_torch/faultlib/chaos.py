"""Seeded chaos smoke harness (``chaos --smoke``; a port of the JAX
package's ``faultlib/chaos.py``: the same schedule, legs and invariants).

A fast acceptance run for the failpoint subsystem: arm a tiny seeded
schedule against REAL components — the loader's retry-then-substitute
path, the checkpoint store + manifest + verified-restore walk-back, the
micro-batcher's per-flush error relay, the elastic agent, the fleet
router and the rollout controller — and assert the recovery invariants
hold, twice, with identical injected-event logs (the determinism pin).
No training and no model build, so the whole thing runs in seconds on
the CPU, card or no card. Where the JAX harness saves through orbax, the
checkpoint leg saves through the port's ``train/fault.py::CheckpointStore``
(``<step>/state.pt``); the injected-event log is the JAX harness's.

Legs:

1. **loader** — ``loader.fetch`` IOErrors at p=0.4: every fetch must
   still return a sample (retry or nearest-following substitution),
   skips stay within the recorded budget.
2. **checkpoint** — two verified saves, then a ``checkpoint.write``
   torn-write on the newest step (its ``state.pt`` cut to ``arg``
   bytes): ``verified_restore`` must walk back to the older verifiable
   step and report the torn one discarded.
3. **batcher** — a guaranteed ``batcher.flush`` IOError on the first
   flush: exactly that flush's futures fail, the worker survives, and
   the next flush succeeds.
4. **fleet** — a simulated 2-rank elastic fleet driven single-threaded
   (fake clock, manual beats): a seeded ``heartbeat.beat`` drop kills
   rank 1 on exactly its 2nd lease renewal, the survivor's watchdog
   declares it lost once the lease ages out, writes the shrink intent,
   and the re-form protocol (claim → plan) lands on a 1-rank fleet;
   then a seeded ``collective.init`` drop replays the bring-up-time
   variant of the same loss.  The machinery of ``parallel/elastic.py``,
   minus the process boundaries (the supervisor that owns them is
   ROADMAP Queue A item 8).
5. **fleet_router** — a 3-replica serving fleet driven single-threaded
   (fake clock, manual probes, hedging off): a seeded ``router.probe``
   IOError delays one replica's admission by exactly one probe round, a
   seeded ``router.dispatch`` drop kills the selected replica
   mid-request through the router's kill hook — failover must answer
   the request anyway — then the dead replica's lease ages out
   (DEAD, out of rotation), it revives, and rejoins after
   ``rejoin_probes`` clean probes.  Same machinery as the real
   ``fleet`` subcommand (serving/fleet/), minus the processes.
6. **rollout** — a rolling weight rollout over a 3-replica fleet driven
   single-threaded (fake clock, injected sleep/probe): an unpublished
   version is rejected by the pre-drain eligibility gate without
   touching any replica, then a seeded ``rollout.swap`` drop kills the
   first wave mid-swap (after hold+drain, before the swap RPC) — the
   controller must abort the wave, reverse-roll the drained replica,
   and reconverge the fleet on the old version — and the retry wave
   (the drop is spent) must hold/drain/swap/rejoin every replica,
   canary-gate the first one, and land the whole fleet on the new
   version.  Same machinery as the real ``rollout`` subcommand
   (serving/rollout/), minus the processes.
7. **determinism** — all legs run twice under the same seed; the two
   injected-event logs must match exactly.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

import numpy as np

from replication_faster_rcnn_tpu_torch.faultlib import failpoints

__all__ = ["ChaosSmokeError", "run_smoke", "smoke_rules"]


class ChaosSmokeError(AssertionError):
    """A recovery invariant did not hold under the injected schedule."""


def smoke_rules(seed: int) -> List[failpoints.Rule]:
    """The smoke schedule: loader IOErrors, one torn checkpoint write,
    one flush IOError — all decided by ``seed``."""
    return [
        failpoints.Rule("loader.fetch", "ioerror", 0.4, seed),
        # the FIRST save lands clean so the walk-back has somewhere to go;
        # the second is torn mid-write (after=1, max_fires=1 → exactly hit 1)
        failpoints.Rule(
            "checkpoint.write", "torn_write", 1.0, seed + 1,
            arg=4, max_fires=1, after=1,
        ),
        failpoints.Rule(
            "batcher.flush", "ioerror", 1.0, seed + 2, max_fires=1
        ),
        # the fleet leg beats ranks 0,1 strictly alternating through ONE
        # registry, so per-site hit indices map onto ranks: after=3 lands
        # the drop on hit 3 = rank 1's 2nd renewal (arg names the victim)
        failpoints.Rule(
            "heartbeat.beat", "drop", 1.0, seed + 3,
            arg=1, max_fires=1, after=3,
        ),
        # bring-up variant: inits fire rank 0 then rank 1, after=1 lands
        # the drop on rank 1's init
        failpoints.Rule(
            "collective.init", "drop", 1.0, seed + 4,
            arg=1, max_fires=1, after=1,
        ),
        # fleet_router leg: dispatch attempts hit in request order —
        # requests a, b pass (hits 0, 1), the drop lands on request c's
        # first attempt (hit 2) and the router's kill hook makes the
        # selected replica actually die; the failover attempt is hit 3
        failpoints.Rule(
            "router.dispatch", "drop", 1.0, seed + 5, max_fires=1, after=2
        ),
        # probes hit per replica in registration order (r0, r1, r2 per
        # round): after=4 fails exactly r1's probe in round 2, delaying
        # its admission to rotation by one round — transient, max_fires=1
        failpoints.Rule(
            "router.probe", "ioerror", 1.0, seed + 6, max_fires=1, after=4
        ),
        # rollout leg: the first rollout.swap hit is wave 1's first
        # replica (post-drain, pre-RPC) — the mid-swap kill. max_fires=1
        # spends the rule, so the retry wave's three hits pass clean
        failpoints.Rule(
            "rollout.swap", "drop", 1.0, seed + 7, max_fires=1
        ),
    ]


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ChaosSmokeError(msg)


def _loader_leg(seed: int) -> Dict[str, Any]:
    from replication_faster_rcnn_tpu_torch.config import DataConfig
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.data.loader import fetch_sample

    cfg = DataConfig(dataset="synthetic", image_size=(16, 16), max_boxes=4)
    ds = SyntheticDataset(cfg, length=8)
    skips: List[int] = []
    for i in range(len(ds)):
        sample = fetch_sample(ds, i, on_skip=lambda idx, exc: skips.append(idx))
        _check(
            isinstance(sample, dict) and "image" in sample,
            f"loader leg: fetch_sample({i}) returned no sample under faults",
        )
        _check(
            np.isfinite(np.asarray(sample["image"])).all(),
            f"loader leg: substituted sample {i} is not finite",
        )
    return {"fetches": len(ds), "skipped": len(skips)}


def _checkpointed_save(store, workdir: str, step: int, state) -> None:
    """One save through the same failpoint wiring the trainer uses:
    consult ``checkpoint.write`` first (ioerror raises before any bytes
    land), save + manifest, then apply a returned torn-write/CRC fault
    to the step directory so restore-time verification must catch it."""
    from replication_faster_rcnn_tpu_torch.train import fault

    inj = failpoints.fire("checkpoint.write", step=int(step), writer="smoke")
    store.save(step, state)
    store.wait_until_finished()
    fault.write_manifest(workdir, step, state, None, kind="scheduled")
    if inj is not None and inj.kind in ("torn_write", "crc_corrupt"):
        step_dir = failpoints.find_step_dir(
            workdir, step, exclude=(fault.MANIFEST_DIRNAME,)
        )
        _check(step_dir is not None, f"checkpoint leg: no step dir for {step}")
        touched = failpoints.apply_file_fault(inj, step_dir)
        _check(bool(touched), f"checkpoint leg: fault touched no files at {step}")


def _checkpoint_leg(workdir: str, seed: int) -> Dict[str, Any]:
    import torch

    from replication_faster_rcnn_tpu_torch.train import fault

    rng = np.random.RandomState(seed)
    state = {
        "params": {"w": torch.from_numpy(rng.rand(8, 8).astype(np.float32))},
        "step": torch.zeros((), dtype=torch.int64),
    }
    store = fault.CheckpointStore(workdir, max_to_keep=4, create=True)
    # step 1 saves clean (the torn-write rule is max_fires=1 but its
    # decision stream may pass early hits); keep saving until the single
    # torn write lands, then verify the walk-back
    torn_step = None
    for step in (1, 2, 3):
        state = dict(state, step=torch.full((), step, dtype=torch.int64))
        before = len(failpoints.event_log())
        _checkpointed_save(store, workdir, step, state)
        fired = [
            e
            for e in failpoints.event_log()[before:]
            if e["site"] == "checkpoint.write"
        ]
        if fired:
            torn_step = step
            break
    _check(
        torn_step is not None,
        "checkpoint leg: torn-write rule (prob=1.0) never fired",
    )
    logs: List[str] = []
    result = fault.verified_restore(store, workdir, log=logs.append)
    _check(
        result.step is not None and result.step < torn_step,
        f"checkpoint leg: restored step {result.step} is not older than "
        f"the torn step {torn_step}",
    )
    _check(
        any(s == torn_step for s, _ in result.discarded),
        f"checkpoint leg: torn step {torn_step} was not discarded "
        f"(discarded={result.discarded})",
    )
    _check(
        fault.verify_state(result.manifest, result.state) == [],
        "checkpoint leg: fallback state failed manifest verification",
    )
    return {"torn_step": torn_step, "restored_step": result.step}


def _batcher_leg() -> Dict[str, Any]:
    from replication_faster_rcnn_tpu_torch.serving.batcher import MicroBatcher

    # threadless mode (start=False + explicit _service_once): grouping is
    # deterministic — both submits land in ONE flush of 2, so exactly one
    # batcher.flush hit is consulted per pair regardless of scheduling
    with MicroBatcher(
        lambda key, items: [x * 2 for x in items],
        max_batch=2,
        max_delay_s=60.0,
        depth=8,
        name="chaos-smoke-batcher",
        start=False,
    ) as mb:
        first = [mb.submit("k", i) for i in range(2)]
        mb._service_once(block=False)  # queues entry 0 (group of 1)
        mb._service_once(block=False)  # entry 1 completes the group: flush
        errs = []
        for f in first:
            try:
                f.result(timeout=0)
            except failpoints.ChaosError as e:
                errs.append(e)
        _check(
            len(errs) == 2,
            f"batcher leg: injected flush IOError hit {len(errs)}/2 futures",
        )
        # the batcher must survive the failed flush (max_fires=1 spent)
        second = [mb.submit("k", i) for i in range(2)]
        mb._service_once(block=False)
        mb._service_once(block=False)
        got = [f.result(timeout=0) for f in second]
        _check(got == [0, 2], f"batcher leg: post-fault flush returned {got}")
    return {"failed_futures": len(errs), "recovered": True}


def _fleet_leg(workdir: str, seed: int) -> Dict[str, Any]:
    import os

    from replication_faster_rcnn_tpu_torch.parallel import elastic

    fleet_dir = os.path.join(workdir, "fleet")
    now = [0.0]
    dead: List[int] = []
    incidents: List[Dict[str, Any]] = []

    def _agent(rank: int) -> elastic.ElasticAgent:
        return elastic.ElasticAgent(
            fleet_dir,
            generation=0,
            rank=rank,
            world=2,
            heartbeat_interval_s=0.5,
            lease_timeout_s=1.0,
            clock=lambda: now[0],
            # sudden death, minus the os._exit: the rank just stops beating
            on_drop=lambda r=rank: dead.append(r),
            on_lost=lambda lost, survivors: incidents.append(
                {"event": "fleet_rank_lost", "lost": lost, "survivors": survivors}
            ),
            exit_on_shrink=False,
        )

    agents = [_agent(0), _agent(1)]
    # strict r0,r1 beat alternation through the shared registry — the
    # smoke rule's after=3 deterministically lands the drop on rank 1's
    # 2nd renewal (hit 3); a dead rank never beats again
    for _ in range(2):
        for a in agents:
            if a.rank not in dead:
                a.beat()
        now[0] += 0.5
    _check(dead == [1], f"fleet leg: seeded drop killed ranks {dead}, not [1]")

    # the survivor keeps renewing; rank 1's lease (last written at t=0.0)
    # ages past the 1.0s timeout while rank 0's stays fresh
    lost: List[int] = []
    for _ in range(3):
        agents[0].beat()
        lost = agents[0].lost_ranks()
        if lost:
            break
        now[0] += 0.5
    _check(lost == [1], f"fleet leg: watchdog saw lost={lost}, want [1]")
    # the watchdog's loss path: observer -> durable intent -> check()
    # (exit_on_shrink=False stands in for the os._exit(76) hand-off)
    agents[0]._on_peer_lost(lost)
    _check(
        agents[0].check() == [1],
        f"fleet leg: main-thread check() saw {agents[0].check()}, want [1]",
    )
    intent = elastic.read_intent(fleet_dir, 0)
    _check(
        intent is not None
        and intent["lost"] == [1]
        and intent["survivors"] == [0],
        f"fleet leg: durable shrink intent is wrong: {intent}",
    )
    _check(
        incidents == [{"event": "fleet_rank_lost", "lost": [1], "survivors": [0]}],
        f"fleet leg: on_lost observer saw {incidents}",
    )

    # re-form: the survivor claims generation 1; as lowest claimant it
    # arbitrates the plan — a 1-rank fleet
    elastic.write_claim(fleet_dir, 1, 0)
    claims = elastic.read_claims(fleet_dir, 1, 2)
    _check(claims == [0], f"fleet leg: gen-1 claims {claims}, want [0]")
    elastic.write_plan(fleet_dir, 1, claims)
    plan = elastic.read_plan(fleet_dir, 1)
    _check(
        plan == {"generation": 1, "survivors": [0], "world": 1},
        f"fleet leg: gen-1 plan is wrong: {plan}",
    )

    # bring-up variant: replay the same loss at collective-init time —
    # rank 0 inits first, the seeded drop (after=1) names rank 1
    init_deaths: List[int] = []
    for r in (0, 1):
        inj = failpoints.fire("collective.init", num_processes=2, process_id=r)
        if inj is not None and inj.kind == "drop" and int(inj.arg) == r:
            init_deaths.append(r)
    _check(
        init_deaths == [1],
        f"fleet leg: init-time drop killed ranks {init_deaths}, not [1]",
    )
    return {
        "dropped_rank": dead[0],
        "reformed_world": plan["world"],
        "init_dropped_rank": init_deaths[0],
    }


def _fleet_router_leg(seed: int) -> Dict[str, Any]:
    from replication_faster_rcnn_tpu_torch.config import FleetConfig
    from replication_faster_rcnn_tpu_torch.serving import fleet as fleet_mod

    # hedging off + fake clock + manual probes: every failpoint hit index
    # is a pure function of this leg's call sequence, so the seeded
    # schedule replays identically (the determinism pin)
    cfg = FleetConfig(
        hedge=False,
        probe_interval_s=0.5,
        lease_timeout_s=1.2,
        rejoin_probes=2,
        breaker_threshold=2,
        breaker_cooldown_s=1.0,
        cache_entries=8,
        canary_fraction=0.0,
    )
    now = [0.0]
    clients = {
        rid: fleet_mod.LocalReplicaClient(rid, lambda p: p * 2)
        for rid in ("r0", "r1", "r2")
    }
    registry = fleet_mod.ReplicaRegistry(cfg, clock=lambda: now[0])
    for rid, client in clients.items():
        registry.add(rid, client)

    def _probe_round() -> None:
        registry.probe_once()
        now[0] += 0.5

    # round 1: everyone's 1st ok probe; round 2: the seeded router.probe
    # IOError (after=4) fails exactly r1's probe, so r0/r2 reach the
    # rejoin_probes=2 gate and r1 is held back one round
    _probe_round()
    _probe_round()
    _check(
        registry.in_rotation() == ["r0", "r2"],
        f"fleet_router leg: rotation after the faulted probe round is "
        f"{registry.in_rotation()}, want ['r0', 'r2']",
    )
    _probe_round()
    _probe_round()
    _check(
        registry.in_rotation() == ["r0", "r1", "r2"],
        f"fleet_router leg: r1 did not rejoin after the transient probe "
        f"fault: {registry.in_rotation()}",
    )

    router = fleet_mod.FleetRouter(
        registry,
        cfg,
        clock=lambda: now[0],
        kill_hook=lambda rid: clients[rid].kill(),
    )
    # requests a, b dispatch clean (router.dispatch hits 0, 1)
    _check(
        router.dispatch(3, content_hash="img-a") == 6,
        "fleet_router leg: request a returned the wrong result",
    )
    _check(
        router.dispatch(4, content_hash="img-b") == 8,
        "fleet_router leg: request b returned the wrong result",
    )
    # request c: the seeded drop (hit 2) kills its selected replica
    # mid-request; failover (hit 3) must answer anyway
    victim = router.candidates("img-c")[0]
    _check(
        router.dispatch(5, content_hash="img-c") == 10,
        "fleet_router leg: failover did not absorb the replica kill",
    )
    _check(
        clients[victim].killed,
        f"fleet_router leg: kill hook did not kill {victim!r}",
    )
    _check(
        router.stats["failovers"] == 1,
        f"fleet_router leg: failovers={router.stats['failovers']}, want 1",
    )
    # the dead replica stops answering probes; its lease (1.2s) ages out
    # within three 0.5s rounds and the registry declares it DEAD
    for _ in range(3):
        _probe_round()
    _check(
        registry.state_of(victim) == "dead",
        f"fleet_router leg: victim state is {registry.state_of(victim)!r}, "
        "want 'dead' after lease timeout",
    )
    _check(
        victim not in registry.in_rotation(),
        "fleet_router leg: dead replica still in rotation",
    )
    # drain/rejoin: the replica restarts and re-enters rotation after
    # rejoin_probes clean probes — no operator action
    clients[victim].revive()
    _probe_round()
    _probe_round()
    _check(
        registry.state_of(victim) == "healthy",
        f"fleet_router leg: revived replica is "
        f"{registry.state_of(victim)!r}, want 'healthy'",
    )
    # duplicate image: answered from the content-hash cache, no dispatch
    _check(
        router.dispatch(3, content_hash="img-a") == 6
        and router.stats["cache_hits"] == 1,
        "fleet_router leg: duplicate content was not served from cache",
    )
    return {
        "victim": victim,
        "failovers": router.stats["failovers"],
        "cache_hits": router.stats["cache_hits"],
        "rejoined": True,
    }


def _rollout_leg(workdir: str, seed: int) -> Dict[str, Any]:
    import os

    from replication_faster_rcnn_tpu_torch.config import (
        FasterRCNNConfig,
        FleetConfig,
        RolloutConfig,
    )
    from replication_faster_rcnn_tpu_torch.serving import fleet as fleet_mod
    from replication_faster_rcnn_tpu_torch.serving.rollout import (
        RolloutController,
        VersionFeed,
    )
    from replication_faster_rcnn_tpu_torch.train import fault

    # publish two real versions: manifest + feed line + a step dir, so
    # the pre-drain eligibility gate judges the same artifacts the
    # trainer writes (config=None on the feed skips the hash check —
    # there is no training config in this leg)
    wd = os.path.join(workdir, "rollout")
    rng = np.random.RandomState(seed)
    for step in (1, 2):
        state = {"params": {"w": rng.rand(4, 4).astype(np.float32)}}
        os.makedirs(os.path.join(wd, str(step)), exist_ok=True)
        fault.write_manifest(wd, step, state, None, kind="scheduled")
        fault.publish_manifest_event(wd, step)
    feed = VersionFeed(wd, config=None)

    cfg = FasterRCNNConfig().replace(
        fleet=FleetConfig(
            hedge=False,
            probe_interval_s=0.5,
            lease_timeout_s=2.0,
            rejoin_probes=2,
            canary_fraction=0.25,
            cache_entries=0,
        ),
        rollout=RolloutConfig(
            drain_timeout_s=2.0,
            swap_timeout_s=5.0,
            rejoin_timeout_s=10.0,
            canary_hold_s=1.0,
            canary_min_requests=0,
        ),
    )
    # fake replicas: a mutable version map + swap/health callables —
    # LocalReplicaClient's swap() is the same surface the HTTP transport
    # gives the controller against real `serve` replicas
    now = [0.0]
    versions = {"r0": "1", "r1": "1", "r2": "1"}
    clients = {
        rid: fleet_mod.LocalReplicaClient(
            rid,
            lambda p: p * 2,
            health_fn=lambda rid=rid: {
                "ok": True,
                "model_version": versions[rid],
                "bucket_queue_depths": {},
            },
            swap_fn=lambda v, rid=rid: versions.__setitem__(rid, v),
        )
        for rid in ("r0", "r1", "r2")
    }
    registry = fleet_mod.ReplicaRegistry(cfg.fleet, clock=lambda: now[0])
    for rid, client in clients.items():
        registry.add(rid, client)
    for _ in range(cfg.fleet.rejoin_probes):
        registry.probe_once()
        now[0] += 0.5
    _check(
        registry.in_rotation() == ["r0", "r1", "r2"],
        f"rollout leg: fleet never admitted: {registry.in_rotation()}",
    )
    router = fleet_mod.FleetRouter(registry, cfg.fleet, clock=lambda: now[0])
    controller = RolloutController(
        registry,
        router,
        cfg,
        feed=feed,
        clock=lambda: now[0],
        sleep=lambda s: now.__setitem__(0, now[0] + s),
    )

    def _names(result) -> List[str]:
        return [e["event"] for e in result.events]

    # an unpublished version must be rejected before any replica drains
    gate = controller.rollout("9")
    _check(
        gate.outcome == "ineligible"
        and _names(gate) == ["wave_ineligible", "wave_done"],
        f"rollout leg: unpublished version verdict was {gate.outcome!r} "
        f"with events {_names(gate)}",
    )

    # wave 1: the seeded rollout.swap drop is the mid-swap kill on the
    # first (already held + drained) replica — abort, reverse-roll it,
    # reconverge the fleet on the old version
    wave1 = controller.rollout("2")
    _check(
        wave1.outcome == "aborted"
        and "injected mid-swap kill" in (wave1.reason or ""),
        f"rollout leg: wave 1 was {wave1.outcome!r} ({wave1.reason!r}), "
        "want the injected abort",
    )
    _check(
        _names(wave1)
        == [
            "wave_started",
            "replica_hold",
            "wave_aborted",
            "replica_rolled_back",
            "wave_done",
        ],
        f"rollout leg: wave 1 events were {_names(wave1)}",
    )
    _check(
        registry.in_rotation() == ["r0", "r1", "r2"]
        and set(versions.values()) == {"1"}
        and set(registry.model_versions().values()) == {"1"},
        "rollout leg: fleet did not reconverge on the old version after "
        f"the aborted wave (versions={versions}, "
        f"rotation={registry.in_rotation()})",
    )

    # wave 2: the drop is spent — hold/drain/swap/rejoin each replica,
    # canary-gate the first, promote, finish the wave
    wave2 = controller.rollout("2")
    _check(
        wave2.outcome == "promoted"
        and wave2.swapped == ["r0", "r1", "r2"],
        f"rollout leg: retry wave was {wave2.outcome!r} "
        f"(swapped={wave2.swapped}), want a full promotion",
    )
    _check(
        "canary_promoted" in _names(wave2),
        f"rollout leg: retry wave skipped the canary gate: {_names(wave2)}",
    )
    _check(
        registry.in_rotation() == ["r0", "r1", "r2"]
        and set(versions.values()) == {"2"}
        and set(registry.model_versions().values()) == {"2"},
        "rollout leg: fleet did not land on the new version "
        f"(versions={versions}, registry={registry.model_versions()})",
    )
    _check(
        all(registry.role_of(rid) == "serving" for rid in clients),
        f"rollout leg: a canary role leaked past promotion: "
        f"{[registry.role_of(rid) for rid in clients]}",
    )
    return {
        "gate": gate.outcome,
        "wave1": wave1.outcome,
        "wave1_rolled_back": wave1.rolled_back,
        "wave2": wave2.outcome,
        "final_versions": dict(versions),
    }


def _one_pass(workdir: str, seed: int) -> Dict[str, Any]:
    failpoints.configure(smoke_rules(seed))
    try:
        legs = {
            "loader": _loader_leg(seed),
            "checkpoint": _checkpoint_leg(workdir, seed),
            "batcher": _batcher_leg(),
            "fleet": _fleet_leg(workdir, seed),
            "fleet_router": _fleet_router_leg(seed),
            "rollout": _rollout_leg(workdir, seed),
        }
        events = failpoints.event_log()
    finally:
        failpoints.disarm()
    return {"legs": legs, "events": events}


def run_smoke(workdir: str, seed: int = 0) -> Dict[str, Any]:
    """Run the smoke schedule twice under ``seed`` and assert every
    recovery invariant plus run-to-run event-log identity. Raises
    :class:`ChaosSmokeError` on any violation; returns a summary."""
    import os

    t0 = time.monotonic()
    first = _one_pass(os.path.join(workdir, "pass1"), seed)
    second = _one_pass(os.path.join(workdir, "pass2"), seed)
    _check(
        first["events"] == second["events"],
        "determinism leg: the same seed produced different injected-event "
        f"logs\nfirst:  {json.dumps(first['events'])}\n"
        f"second: {json.dumps(second['events'])}",
    )
    _check(bool(first["events"]), "determinism leg: schedule injected nothing")
    return {
        "ok": True,
        "seed": seed,
        "legs": first["legs"],
        "injected_events": len(first["events"]),
        "events": first["events"],
        "elapsed_s": round(time.monotonic() - t0, 3),
    }
