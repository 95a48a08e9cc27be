"""The PyTorch port's serving fleet, rolling rollout, elastic agent and chaos
smoke against the JAX package's, on the CPU. Host code only: no model is
built here (the fleet over real engines is
``tests/test_torch_serving_stack.py::test_fleet_over_engines_matches_jax``).

Every case puts the same scripted inputs, fake clocks and failpoint rules
through the JAX module and the port module and asserts equal results. Three
test ids, each a loop over cases (each id costs the fast tier's budget 2 s):

* ``test_fleet_host_modules_match_jax``: circuit-breaker state sequences,
  ``HashRing.ordered`` for 1,000 ``content_key``s at 64 vnodes with a node
  removed, registry snapshots and events over a probe and lease timeline
  with a ``router.probe`` fault, and router results, ``stats``,
  ``snapshot()`` and ``canary_report`` over scripted requests (failover, a
  ``router.dispatch`` drop, cache hits and evictions, the canary slice, its
  demotion, shadow diffs), hedging off; then hedged requests on the real
  clock (a hedge that wins, a failed hedge relaunched, the deadline).
* ``test_rollout_and_elastic_match_jax``: ``VersionFeed`` over one workdir
  the port's ``Trainer`` wrote at 96x96 (a pruned version, a manifest torn
  by the ``checkpoint.manifest`` failpoint, one without a step directory,
  one with a wrong leaf count), rollout waves over fakes (ineligible, the
  ``rollout.swap`` abort, promotion, noop, the ``rollout.promote``
  rollback, a shadow-diff rollback, a rejoin timeout, the watcher), and
  the ``ElasticAgent``'s lease, intent, claim and plan files byte for byte.
* ``test_chaos_smoke_matches_jax``: ``chaos.run_smoke`` for seeds 0, 1 and
  2: legs and injected-event logs equal (``elapsed_s`` and paths aside).
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.faultlib import chaos as j_chaos
from replication_faster_rcnn_tpu.faultlib import failpoints as j_failpoints
from replication_faster_rcnn_tpu.parallel import elastic as j_elastic
from replication_faster_rcnn_tpu.serving import fleet as j_fleet
from replication_faster_rcnn_tpu.serving import rollout as j_rollout
from replication_faster_rcnn_tpu.serving.fleet import breaker as j_breaker
from replication_faster_rcnn_tpu.serving.fleet import router as j_router
from replication_faster_rcnn_tpu.train import fault as j_fault
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.faultlib import chaos, failpoints
from replication_faster_rcnn_tpu_torch.parallel import elastic
from replication_faster_rcnn_tpu_torch.serving import fleet, rollout
from replication_faster_rcnn_tpu_torch.serving.fleet import breaker, router
from replication_faster_rcnn_tpu_torch.train import fault

SIDES = {
    "torch": types.SimpleNamespace(config=tconfig, failpoints=failpoints, fleet=fleet,
                                   breaker=breaker, router=router, rollout=rollout,
                                   elastic=elastic, chaos=chaos, fault=fault),
    "jax": types.SimpleNamespace(config=jconfig, failpoints=j_failpoints, fleet=j_fleet,
                                 breaker=j_breaker, router=j_router, rollout=j_rollout,
                                 elastic=j_elastic, chaos=j_chaos, fault=j_fault),
}


def _both(script, *args):
    """``script(side, *args)`` on each package; the failpoints of both are
    disarmed after each run."""
    out = {}
    for name, m in SIDES.items():
        try:
            out[name] = script(m, *args)
        finally:
            m.failpoints.disarm()
    return out["torch"], out["jax"]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the same exception type and message on both sides
        return (type(e).__name__, str(e))


def _plain(value):
    """JSON round trip: tuples become lists, as they would on the wire."""
    return json.loads(json.dumps(value, sort_keys=True, default=str))


# ------------------------------------------------------------ fleet cases


def _breaker_script(m, threshold, cooldown_s, seed):
    now = [0.0]
    cb = m.breaker.CircuitBreaker(threshold=threshold, cooldown_s=cooldown_s,
                                  clock=lambda: now[0])
    rng = np.random.default_rng(seed)
    out = []
    for op in rng.integers(0, 4, 300):
        if op == 0:
            out.append(("allow", cb.allow()))
        elif op == 1:
            cb.record_success()
        elif op == 2:
            cb.record_failure()
        else:
            now[0] += float(rng.choice([0.25, 0.5, 1.0]))
        out.append((cb.state, cb.snapshot()))
    out.append(_outcome(m.breaker.CircuitBreaker, threshold=0))
    out.append(_outcome(m.breaker.CircuitBreaker, cooldown_s=0))
    return _plain(out)


def _ring_script(m):
    keys = [m.router.content_key(f"img-{i}".encode()) for i in range(1000)]
    nodes = ["r0", "r1", "r2", "r3"]
    full = m.router.HashRing(nodes, vnodes=64)
    less = m.router.HashRing([n for n in nodes if n != "r2"], vnodes=64)
    return (keys, [full.ordered(k) for k in keys], [less.ordered(k) for k in keys],
            m.router.HashRing([], vnodes=64).ordered("x"),
            _outcome(m.router.HashRing, nodes, vnodes=0))


def _fleet_cfg(m, **kw):
    kw.setdefault("probe_interval_s", 0.5)
    kw.setdefault("lease_timeout_s", 1.2)
    kw.setdefault("rejoin_probes", 2)
    kw.setdefault("hedge", False)
    kw.setdefault("canary_fraction", 0.0)
    return m.config.FleetConfig(**kw)


def _registry_script(m):
    """Probe rounds on a fake clock: admission, a ``router.probe`` IOError,
    a kill and lease expiry, revival, draining and degraded replicas, a
    rollout hold, role changes, bad calls and removal."""
    m.failpoints.configure([m.failpoints.Rule("router.probe", "ioerror", 1.0, 3,
                                              max_fires=2, after=5)])
    now = [0.0]
    health = {rid: {"ok": True, "params_dtype": "bfloat16", "model_version": "1"}
              for rid in ("r0", "r1", "canary0", "shadow0")}
    clients = {rid: m.fleet.LocalReplicaClient(rid, lambda p: p, health_fn=lambda rid=rid:
                                               dict(health[rid]))
               for rid in health}
    reg = m.fleet.ReplicaRegistry(_fleet_cfg(m), clock=lambda: now[0])
    for rid, role in (("r0", "serving"), ("r1", "serving"), ("canary0", "canary"),
                      ("shadow0", "shadow")):
        reg.add(rid, clients[rid], role=role)
    out = []

    def rounds(n, note):
        for _ in range(n):
            reg.probe_once()
            now[0] += 0.5
        out.append((note, reg.snapshot(), [reg.in_rotation(r) for r in
                                           ("serving", "canary", "shadow")]))

    rounds(3, "admitted")
    clients["r1"].kill()
    rounds(3, "r1 dead")
    clients["r1"].revive()
    health["r1"]["model_version"] = "2"
    rounds(2, "r1 rejoined")
    health["r0"]["draining"] = True
    rounds(1, "r0 draining")
    health["r0"].update(draining=False, degraded=True, degraded_reason="3 flush errors")
    rounds(1, "r0 degraded")
    health["r0"]["degraded"] = False
    rounds(2, "r0 clean")
    reg.hold("r0", reason="rollout to 2")
    rounds(3, "r0 held")
    reg.release("r0")
    rounds(1, "r0 released")
    rounds(1, "r0 rejoined")
    reg.set_role("canary0", "serving", reason="slo burn-rate alarm")
    out.append([_outcome(reg.set_role, "r0", "primary"),
                _outcome(reg.add, "r0", clients["r0"]),
                _outcome(reg.add, "r9", clients["r0"], role="primary"),
                _outcome(reg.hold, "r9"), reg.model_versions(), reg.model_version_of("r1"),
                reg.role_of("canary0"), reg.state_of("r1")])
    reg.remove("shadow0")
    rounds(1, "shadow0 removed")
    return _plain([out, reg.events(), m.failpoints.event_log()])


def _router_script(m):
    """Scripted requests through a 3-replica fleet with a canary and a
    shadow: cache hits and evictions (4 entries), a ``router.dispatch`` drop
    through the kill hook, failover past a dead replica, an open breaker and
    its half-open trial, shadow diffs on every third payload, and a fleet
    with nothing in rotation."""
    m.failpoints.configure([m.failpoints.Rule("router.dispatch", "drop", 1.0, 5,
                                              max_fires=1, after=3)])
    now = [0.0]
    clients = {rid: m.fleet.LocalReplicaClient(rid, lambda p: p * 2)
               for rid in ("r0", "r1", "r2", "canary0")}
    clients["shadow0"] = m.fleet.LocalReplicaClient(
        "shadow0", lambda p: p * 2 + (1 if p % 3 == 0 else 0))
    cfg = _fleet_cfg(m, cache_entries=4, canary_fraction=0.3, breaker_threshold=2,
                     breaker_cooldown_s=1.0, lease_timeout_s=600.0)
    reg = m.fleet.ReplicaRegistry(cfg, clock=lambda: now[0])
    for rid in clients:
        role = "canary" if rid == "canary0" else "shadow" if rid == "shadow0" else "serving"
        reg.add(rid, clients[rid], role=role)
    for _ in range(cfg.rejoin_probes):
        reg.probe_once()
    rt = m.fleet.FleetRouter(reg, cfg, clock=lambda: now[0],
                             kill_hook=lambda rid: clients[rid].kill())
    out = []
    for i in range(40):
        if i == 12:
            clients["r2"].kill()
        if i == 24:
            for rid in ("r0", "r1", "r2", "canary0"):
                clients[rid].revive()
            now[0] += 1.5  # past every breaker's cooldown: half-open trials
        k = i % 3 if i % 4 == 0 else i % 11  # repeats, some inside the cache's 4
        h = m.router.content_key(f"img-{k}".encode())
        out.append((i, rt.candidates(h), _outcome(rt.dispatch, k, content_hash=h)))
    report = rt.canary_report("canary0")
    snap = rt.snapshot()
    for rid in clients:
        clients[rid].kill()
    down = _outcome(rt.dispatch, 99, content_hash="fresh")
    down = (down[0], down[1].split(" (trace")[0])  # the trace id is random
    empty = m.fleet.FleetRouter(m.fleet.ReplicaRegistry(cfg, clock=lambda: now[0]), cfg,
                                clock=lambda: now[0])
    none = _outcome(empty.dispatch, 1, content_hash="x")
    rt.close()
    return _plain([out, rt.stats, snap, report, down, (none[0], none[1].split(" (trace")[0]),
                   reg.events(), m.failpoints.event_log(), rt.hedge_delay_s()])


def _canary_demotion_script(m):
    """A dead canary under a breaker that never opens: every request it
    fails over, and the router demotes it after CANARY_SLO_MIN_SAMPLES
    failed attempts."""
    clients = {rid: m.fleet.LocalReplicaClient(rid, lambda p, rid=rid: rid)
               for rid in ("r0", "canary0")}
    cfg = _fleet_cfg(m, canary_fraction=0.5, cache_entries=0, lease_timeout_s=600.0,
                     breaker_threshold=10 * m.router.CANARY_SLO_MIN_SAMPLES)
    now = [0.0]
    reg = m.fleet.ReplicaRegistry(cfg, clock=lambda: now[0])
    reg.add("r0", clients["r0"])
    reg.add("canary0", clients["canary0"], role="canary")
    for _ in range(cfg.rejoin_probes):
        reg.probe_once()
    rt = m.fleet.FleetRouter(reg, cfg, clock=lambda: now[0])
    clients["canary0"].kill()
    hashes = [m.router.content_key(f"img-{i}".encode()) for i in range(256)]
    served = [rt.dispatch("x", content_hash=h) for h in hashes]
    return _plain([served, rt.stats, rt.canary_report("canary0"), reg.events(),
                   reg.role_of("canary0")])


HEDGE_CASES = (  # what the replicas at each place of a request's candidate order do
    ("fast",),
    ("slow", "fast"),
    ("fail", "fast"),
    ("slow", "fail", "fast"),
    ("slow", "slow"),
    ("fail", "fail", "fail"),
)


def _hedge_script(m):
    """Hedged dispatch on the router's real clock with the hedge delay
    pinned at 300 ms: per case a fresh router (so each case's counters are
    its own) and one request whose candidates answer at once ("fast"), fail
    at once ("fail") or hold until the request has returned ("slow"). A slow
    primary is hedged to the next candidate, which wins; a failed hedge is
    relaunched on the third; two slow attempts run out the 0.9 s request
    deadline. ``close()`` waits for the losers, so their accounting is in
    the counters read after it."""
    now = [0.0]
    act = {}
    release = threading.Event()

    def predict(rid, p):
        kind = act[rid]
        if kind == "slow":
            release.wait(10.0)
        if kind == "fail":
            raise RuntimeError(f"{rid} failed")
        return [rid, p * 2]

    clients = {rid: m.fleet.LocalReplicaClient(rid, lambda p, rid=rid: predict(rid, p))
               for rid in ("r0", "r1", "r2")}
    cfg = _fleet_cfg(m, hedge=True, hedge_floor_ms=300.0, hedge_ceiling_ms=300.0,
                     max_attempts=3, cache_entries=0, lease_timeout_s=600.0,
                     request_timeout_s=0.9, breaker_threshold=10)
    reg = m.fleet.ReplicaRegistry(cfg, clock=lambda: now[0])
    for rid in clients:
        reg.add(rid, clients[rid])
    for _ in range(cfg.rejoin_probes):
        reg.probe_once()
    out = []
    for i, case in enumerate(HEDGE_CASES):
        rt = m.fleet.FleetRouter(reg, cfg)
        h = m.router.content_key(f"hedge-{i}".encode())
        order = rt.candidates(h)
        act.clear()
        act.update({rid: case[j] if j < len(case) else "fast" for j, rid in enumerate(order)})
        release.clear()
        try:
            got = _outcome(rt.dispatch, i, content_hash=h)
        finally:
            release.set()
            rt.close()
        if got[0] != "ok":
            got = (got[0], got[1].split(" (trace")[0])  # the trace id is random
        out.append((case, order, got, rt.stats, rt.hedge_delay_s()))
    return _plain(out)


def test_fleet_host_modules_match_jax():
    for threshold, cooldown_s, seed in ((1, 0.5, 0), (3, 1.0, 1), (2, 2.0, 2)):
        got, want = _both(_breaker_script, threshold, cooldown_s, seed)
        assert got == want, (threshold, cooldown_s, seed)
    got, want = _both(_ring_script)
    assert got == want
    keys, full, less = got[:3]
    assert all(sorted(o) == ["r0", "r1", "r2", "r3"] for o in full)
    # removing r2 moves only the keys r2 owned
    assert all(f[0] == l[0] for f, l in zip(full, less) if f[0] != "r2")
    runs = {}
    for script in (_registry_script, _router_script, _canary_demotion_script, _hedge_script):
        got, want = _both(script)
        assert got == want, script.__name__
        runs[script.__name__] = got
    demoted = runs["_canary_demotion_script"]
    assert [e["event"] for e in demoted[3]].count("replica_role_changed") == 1
    assert demoted[4] == "serving" and demoted[1]["canary_demotions"] == 1
    routed = runs["_router_script"]
    stats = routed[1]
    assert stats["cache_hits"] > 0 and stats["failovers"] >= 2 and stats["shadow_diffs"] > 0
    assert routed[4][0] == "FleetUnavailable" and routed[5][0] == "FleetUnavailable"
    assert [e["site"] for e in routed[7]] == ["router.dispatch"]
    hedged = {tuple(case): (got, stats) for case, _, got, stats, _ in runs["_hedge_script"]}
    assert hedged[("fast",)][1]["hedges"] == 0
    got, stats = hedged[("slow", "fast")]
    assert got[0] == "ok" and stats["hedges"] == stats["hedge_wins"] == 1
    got, stats = hedged[("slow", "fail", "fast")]
    assert got[0] == "ok" and (stats["hedges"], stats["hedge_wins"], stats["failovers"]) == (1, 0, 1)
    assert hedged[("slow", "slow")][0][0] == "FleetUnavailable"
    assert hedged[("fail", "fail", "fail")][1]["failovers"] == 3


# --------------------------------------------------------- rollout cases


def _trainer_workdir(root):
    """Versions 1-4 saved by the port's Trainer at 96x96 (one train step
    between saves; the store keeps 3, so version 1 is pruned; version 3's
    manifest torn by the ``checkpoint.manifest`` failpoint), and two hand
    made: 6 (a manifest without a step directory) and 7 (a wrong leaf
    count)."""
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer
    from tests.test_torch_train import tcfg_small

    cfg = tcfg_small("voc_resnet18")
    trainer = Trainer(cfg, SyntheticDataset(cfg.data, length=4), device="cpu",
                      workdir=str(root))
    batch = next(iter(trainer.loader))
    failpoints.configure("checkpoint.manifest:torn_write:1.0:0:40:1:2")
    try:
        for step in (1, 2, 3, 4):
            trainer.train_one_batch(batch)
            assert trainer.save(step=step)
    finally:
        failpoints.disarm()
    mdir = root / "manifests"
    four = json.loads((mdir / "4.json").read_text())
    (mdir / "6.json").write_text(json.dumps(dict(four, step=6)))
    two = json.loads((mdir / "2.json").read_text())
    (mdir / "7.json").write_text(json.dumps(dict(two, step=7, leaf_count=two["leaf_count"] + 1)))
    (root / "7").mkdir()
    return cfg


def _feed_script(m, wd):
    feed = m.rollout.VersionFeed(str(wd), config=None)
    verdicts = [(v.step, v.eligible, v.reasons, v.manifest, v.version)
                for v in map(feed.validate, feed.poll())]
    latest = [(e.step if e else None) for e in (feed.latest_eligible(),
                                                feed.latest_eligible(after=2),
                                                feed.latest_eligible(after=4))]
    empty = m.rollout.VersionFeed(str(wd / "none"), config=None)
    return _plain([feed.poll(), verdicts, latest, empty.poll(), empty.latest_eligible()])


def _int8_feed_script(m, wd):
    """The int8 check with the config hash off: a missing sidecar makes
    every version ineligible, with the JAX package's reason."""
    cfg = m.config.get_config("voc_resnet18")
    cfg = cfg.replace(serving=type(cfg.serving)(**{**cfg.serving.__dict__,
                                                   "params_dtype": "int8"}),
                      rollout=m.config.RolloutConfig(require_config_hash=False))
    feed = m.rollout.VersionFeed(str(wd), config=cfg)
    # the loader's hint after the path names each package's own functions
    return _plain([(v.step, v.eligible, [r.split(" — ")[0] for r in v.reasons])
                   for v in map(feed.validate, feed.poll())])


def _rollout_script(m, wd):
    """Waves over three fake replicas and a shadow on a fake clock whose
    sleeps send one request through the router: an ineligible version, the
    ``rollout.swap`` abort, promotion, a noop, the ``rollout.promote``
    rollback, a shadow-diff rollback, a replica whose swap does not take
    (rejoin timeout), and the watcher's poll."""
    m.failpoints.configure([
        m.failpoints.Rule("rollout.swap", "drop", 1.0, 7, max_fires=1),
        m.failpoints.Rule("rollout.promote", "drop", 1.0, 8, max_fires=1, after=1),
    ])
    feed = m.rollout.VersionFeed(str(wd), config=None)
    cfg = m.config.FasterRCNNConfig().replace(
        fleet=_fleet_cfg(m, lease_timeout_s=2.0, canary_fraction=0.5, cache_entries=0),
        rollout=m.config.RolloutConfig(drain_timeout_s=2.0, swap_timeout_s=5.0,
                                       rejoin_timeout_s=3.0, canary_hold_s=1.0,
                                       max_shadow_diff_fraction=0.25))
    now = [0.0]
    versions = {"r0": "2", "r1": "2", "r2": "2", "shadow0": "2"}
    stuck = set()
    shadow_bad = [False]

    def swap(rid, v):
        if rid not in stuck:
            versions[rid] = v

    def predict(rid, p):
        if rid == "shadow0" and shadow_bad[0]:
            return ["other", p]
        return ["det", p]

    clients = {rid: m.fleet.LocalReplicaClient(
        rid, lambda p, rid=rid: predict(rid, p),
        health_fn=lambda rid=rid: {"ok": True, "model_version": versions[rid],
                                   "bucket_queue_depths": {"600x600": 0}},
        swap_fn=lambda v, rid=rid: swap(rid, v)) for rid in versions}
    reg = m.fleet.ReplicaRegistry(cfg.fleet, clock=lambda: now[0])
    for rid, client in clients.items():
        reg.add(rid, client, role="shadow" if rid == "shadow0" else "serving")
    for _ in range(cfg.fleet.rejoin_probes):
        reg.probe_once()
        now[0] += 0.5
    rt = m.fleet.FleetRouter(reg, cfg.fleet, clock=lambda: now[0])
    sent = [0]

    def sleep(s):
        now[0] += s
        sent[0] += 1
        rt.dispatch(sent[0], content_hash=m.router.content_key(str(sent[0]).encode()))

    ctl = m.rollout.RolloutController(reg, rt, cfg, feed=feed, clock=lambda: now[0],
                                      sleep=sleep)
    waves = [ctl.rollout("3"), ctl.rollout("4"), ctl.rollout("4"), ctl.rollout("4")]
    waves.append(ctl.rollout("2"))  # the promote drop: rolled back to 4
    shadow_bad[0] = True
    waves.append(ctl.rollout("2"))  # every shadow answer differs: rolled back
    shadow_bad[0] = False
    stuck.add("r1")
    waves.append(ctl.rollout("2"))  # r1's swap does not take: rejoin timeout
    stuck.clear()
    watcher = m.rollout.RolloutWatcher(feed, ctl)
    polled = [watcher.poll_once(), watcher.poll_once()]
    flat = {k: v for k, v in rt.metrics.counters_flat().items() if k.startswith("rollout_")}
    rt.close()
    return _plain([[w.to_dict() for w in waves], [w.events for w in waves], ctl.events,
                   [p.to_dict() if p else None for p in polled], dict(versions),
                   reg.events(), rt.stats, flat, m.failpoints.event_log()])


def _elastic_script(m, root):
    """The chaos fleet leg's protocol by hand, into ``root``: beats through
    a ``heartbeat.beat`` drop, the watchdog, the shrink intent, claims, the
    plan, ``wait_plan`` and ``clear_fleet_dir``; then every file's bytes."""
    # three ranks beat in turn through one registry: hit 4 is rank 1's second beat
    m.failpoints.configure([m.failpoints.Rule("heartbeat.beat", "drop", 1.0, 3, arg=1,
                                              max_fires=1, after=4)])
    now = [0.0]
    dead, incidents = [], []
    agents = [m.elastic.ElasticAgent(
        str(root), generation=0, rank=r, world=3, heartbeat_interval_s=0.5,
        lease_timeout_s=1.0, clock=lambda: now[0], on_drop=lambda r=r: dead.append(r),
        on_lost=lambda lost, surv: incidents.append((lost, surv)), exit_on_shrink=False)
        for r in range(3)]
    seen = []
    for _ in range(5):
        for a in agents:
            if a.rank not in dead:
                a.beat()
        now[0] += 0.5
        seen.append(agents[0].lost_ranks())
    agents[0]._on_peer_lost(agents[0].lost_ranks())
    survivors = agents[2].declare_shrink([1], step=7)
    for r in survivors:
        m.elastic.write_claim(str(root), 1, r)
    claims = m.elastic.read_claims(str(root), 1, 3)
    m.elastic.write_plan(str(root), 1, claims)
    files = {p.name: p.read_bytes() for p in sorted(root.iterdir())}
    plan = m.elastic.wait_plan(str(root), 1, timeout_s=0.0)
    missing = m.elastic.wait_plan(str(root), 2, timeout_s=0.0)
    m.elastic.clear_fleet_dir(str(root))
    return [dead, seen, incidents, agents[0].check(), survivors, claims, plan, missing,
            m.elastic.read_intent(str(root), 0), sorted(os.listdir(root)), files,
            m.failpoints.event_log(),
            [m.elastic.lease_path("d", 2, 1), m.elastic.intent_path("d", 2),
             m.elastic.claim_path("d", 2, 1), m.elastic.plan_path("d", 2)]]


def test_rollout_and_elastic_match_jax(tmp_path):
    wd = tmp_path / "train"
    cfg = _trainer_workdir(wd)
    got, want = _both(_feed_script, wd)
    assert got == want
    steps = {v[0]: (v[1], v[2]) for v in got[1]}
    assert got[0] == [1, 2, 3, 4, 6, 7] and got[2] == [4, 4, None]
    assert [s for s, (ok, _) in steps.items() if ok] == [2, 4]
    assert "no checkpoint step directory" in steps[6][1][0]
    assert any("torn manifest" in r for r in steps[7][1])
    got, want = _both(_int8_feed_script, wd)
    assert got == want and not any(ok for _, ok, _ in got)
    assert all(r[2] == ["int8 quant sidecar rejected: no quantization sidecar at "
                        f"'{wd / 'quant_artifact.json'}'"] for r in got if r[0] in (2, 4))
    # the port's own config hash check against the config it trained with
    own = rollout.VersionFeed(str(wd), config=cfg).validate(4)
    other = rollout.VersionFeed(str(wd), config=cfg.replace(
        train=type(cfg.train)(**{**cfg.train.__dict__, "lr": 1.0}))).validate(4)
    assert own.eligible and not other.eligible and "config hash" in other.reasons[0]

    got, want = _both(_rollout_script, wd)
    assert got == want
    outcomes = [w["outcome"] for w in got[0]]
    assert outcomes == ["ineligible", "aborted", "promoted", "noop", "rolled_back",
                        "rolled_back", "rolled_back"]
    assert "injected mid-swap kill" in got[0][1]["reason"]
    assert "injected promote failure" in got[0][4]["reason"]
    assert "shadow diff fraction" in got[0][5]["reason"]
    assert "timed out" in got[0][6]["reason"]
    assert got[3][0]["outcome"] == "noop" and got[3][1] is None  # the watcher: 4, then nothing
    assert got[4] == {"r0": "4", "r1": "4", "r2": "4", "shadow0": "2"}  # shadows never roll

    roots = {"torch": tmp_path / "fleet_t", "jax": tmp_path / "fleet_j"}
    got, want = (_elastic_script(SIDES[k], roots[k]) for k in ("torch", "jax"))
    failpoints.disarm()
    j_failpoints.disarm()
    assert got == want
    assert got[0] == [1] and got[4] == [0, 2] and got[6] == {
        "generation": 1, "survivors": [0, 2], "world": 2}
    assert sorted(got[10]) == ["claim_gen1_rank0.json", "claim_gen1_rank2.json",
                               "hb_gen0_rank0.json", "hb_gen0_rank1.json",
                               "hb_gen0_rank2.json", "plan_gen1.json", "shrink_gen0.json"]
    assert got[9] == []
    # the watchdog thread: beats on its own, stops on request
    agent = elastic.ElasticAgent(str(tmp_path / "thread"), 0, 0, 1,
                                 heartbeat_interval_s=0.01, exit_on_shrink=False)
    agent.start()
    for _ in range(200):
        if os.path.exists(elastic.lease_path(agent.fleet_dir, 0, 0)):
            break
        time.sleep(0.01)
    agent.stop()
    assert os.path.exists(elastic.lease_path(agent.fleet_dir, 0, 0)) and agent.check() == []
    assert fault.EXIT_FLEET_SHRINK == j_fault.EXIT_FLEET_SHRINK == 76


# ----------------------------------------------------------- chaos smoke


def test_chaos_smoke_matches_jax(tmp_path):
    for seed in (0, 1, 2):
        got = chaos.run_smoke(str(tmp_path / f"t{seed}"), seed=seed)
        want = j_chaos.run_smoke(str(tmp_path / f"j{seed}"), seed=seed)
        assert got["ok"] and want["ok"]
        assert got["legs"] == want["legs"], seed
        assert got["events"] == want["events"], seed
        assert {k: v for k, v in got.items() if k != "elapsed_s"} == {
            k: v for k, v in want.items() if k != "elapsed_s"}
        assert {e["site"] for e in got["events"]} >= {
            "checkpoint.write", "batcher.flush", "heartbeat.beat", "collective.init",
            "router.dispatch", "router.probe", "rollout.swap"}
    assert chaos.smoke_rules(5) == [failpoints.Rule(**r.__dict__)
                                    for r in j_chaos.smoke_rules(5)]
    # a broken invariant fails the smoke: a checkpoint store that cannot
    # restore anything leaves nothing older to walk back to
    from replication_faster_rcnn_tpu_torch.train import fault as tfault

    real = tfault.CheckpointStore.restore
    tfault.CheckpointStore.restore = lambda self, step: (_ for _ in ()).throw(OSError("gone"))
    try:
        with pytest.raises(chaos.ChaosSmokeError, match="checkpoint leg"):
            chaos.run_smoke(str(tmp_path / "broken"), seed=0)
    finally:
        tfault.CheckpointStore.restore = real
        failpoints.disarm()
    assert not failpoints.armed() and threading.active_count() >= 1
