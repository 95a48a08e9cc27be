"""The PyTorch port's checkpoint, verified restore and preemption machinery
against the JAX package, on the CPU. Two test ids (each id costs the fast
tier's budget 2 s):

* ``test_fault_host_parts_match_jax``: ``train/fault.py``'s host parts
  (``check_step_metrics``, ``SkipMonitor``, ``GracefulShutdown``,
  ``Preempted``), the manifests (a port manifest loads with the JAX
  ``load_manifest``; its CRCs equal the JAX ``_leaf_records``' on equal
  float32 arrays; a corrupted leaf, a wrong leaf count, a missing manifest
  and pruning), ``AsyncCheckpointWriter`` and ``MetricLogger`` rows, on the
  same inputs through both packages. Equal, key for key.
* ``test_kill_and_resume_bitwise``: ResNet18 (ROIAlign) at 96x96, batch 2,
  with the ``__graft_entry__._dryrun_body`` budgets, 3 epochs of 3 steps,
  step 3 poisoned with a NaN (skipped): SIGTERM after step 5 with sync and
  with async saves every 2 steps, then a fresh trainer resumes. The final
  state (parameters, BatchNorm statistics, Adam state, schedule, generator,
  step) and the resumed steps' logged rows are bitwise the uninterrupted
  run's. The same run at ``steps_per_dispatch=2`` (chunks of two steps,
  an epoch's third step through the one-step path, step 2 poisoned inside a
  chunk) ends bitwise in the same state, and the trainer's ``_log_chunk``
  logs the rows the JAX ``_log_chunk`` chooses. Then the newest verified
  weights through ``load_eval_variables``, the fallback past a torn latest
  step, a torn explicit step, save containment, the generator's device
  kind and the refusal of the earlier ``torch.optim.Adam`` layout.

The JAX checkpoint carried into the port is a case of
``tests/test_torch_train.py::test_train_step_losses_match_jax``.
"""

import dataclasses
import io
import json
import os
import signal
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu.telemetry import spans as j_spans
from replication_faster_rcnn_tpu.train import async_checkpoint as j_async
from replication_faster_rcnn_tpu.train import fault as j_fault
from replication_faster_rcnn_tpu.train.trainer import Trainer as JTrainer
from replication_faster_rcnn_tpu.utils.logging import MetricLogger as JMetricLogger
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.train import fault
from replication_faster_rcnn_tpu_torch.train.async_checkpoint import AsyncCheckpointWriter
from replication_faster_rcnn_tpu_torch.train.trainer import Trainer, load_eval_variables
from replication_faster_rcnn_tpu_torch.utils.logging import MetricLogger
from tests.test_torch_train import tcfg_small


# ------------------------------------------------------------ host parts


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the same exception type and message on both sides
        return (type(e).__name__, str(e))


def _case_check_step_metrics():
    rows = [
        ({"loss": 1.5, "skipped": 0.0, "grad_norm": np.float32(2.0)}, 4),
        ({"loss": float("nan"), "skipped": 1.0}, 5),  # withheld: NaN allowed
        ({"loss": float("inf"), "skipped": 0.0}, 6),
        ({"loss": float("nan")}, 7),
    ]
    for row, step in rows:
        got = _outcome(fault.check_step_metrics, row, step)
        want = _outcome(j_fault.check_step_metrics, row, step)
        assert got[0] == want[0] and (got == want or np.isnan(row["loss"])), (got, want)
    assert _outcome(fault.check_step_metrics, *rows[2])[0] == "FloatingPointError"


def _drive_monitor(mod, policy, feed, max_consecutive=3):
    incidents = []
    mon = mod.SkipMonitor(policy, max_consecutive,
                          on_escalate=lambda kind, **f: incidents.append((kind, f)))
    trace = []
    for first, flags, drain in feed:
        try:
            mon.observe(first, {"skipped": flags, "loss": 0.0})
            if drain:
                mon.drain()
        except mod.NonFiniteEscalation as e:  # the advice after "gradients are" differs
            trace.append(("escalated", str(e).split(" not a transient")[0]))
            break
        trace.append((mon.consecutive, mon.total_skipped, mon.last_skipped_step))
    return trace, incidents


def _case_skip_monitor():
    # reset by a clean step, stacked [K] flags, escalation at 3 in a row
    feed = [(1, 1.0, True), (2, 0.0, True), (3, 1.0, False), (4, np.float32(1.0), True),
            (5, np.array([0.0, 1.0, 1.0]), True), (8, 1.0, True), (9, 1.0, True)]
    for policy in ("skip", "halt", "apply"):
        got = _drive_monitor(fault, policy, feed)
        want = _drive_monitor(j_fault, policy, feed)
        assert got == want, policy
        if policy != "apply":  # halt escalates on the first skip, skip on the third
            assert got[0][-1][0] == "escalated" and got[1][0][0] == "nonfinite_escalation"
    with pytest.raises(ValueError):
        fault.SkipMonitor("sometimes")


def _case_shutdown():
    assert fault.EXIT_PREEMPTED == j_fault.EXIT_PREEMPTED == 75
    e = fault.Preempted(5, "SIGTERM")
    assert isinstance(e, RuntimeError) and (e.step, e.reason) == (5, "SIGTERM")
    for sig in (signal.SIGTERM, signal.SIGINT):
        before = signal.getsignal(sig)
        seen = []
        for mod in (fault, j_fault):
            with mod.GracefulShutdown() as sd:
                assert not sd.requested
                signal.raise_signal(sig)
                seen.append((sd.requested, sd.reason))
            assert signal.getsignal(sig) is before  # the handler is restored
        assert seen[0] == seen[1] == (True, signal.Signals(sig).name)
    for mod in (fault, j_fault):
        sd = mod.GracefulShutdown()
        sd.request()
        sd.request("again")  # the first reason stays
        assert sd.requested and sd.reason == "manual"
    # off the main thread no handler is bound, and request() still works
    out = []

    def off_main():
        with fault.GracefulShutdown() as sd:
            out.append(signal.getsignal(signal.SIGTERM))
            sd.request("thread")
            out.append(sd.reason)

    t = threading.Thread(target=off_main)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out == [signal.getsignal(signal.SIGTERM), "thread"]


def _tree(rng):
    return {
        "model": {"conv.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
                  "bn.running_var": rng.uniform(size=(4,)).astype(np.float32)},
        "optimizer": {"state": {0: {"exp_avg": rng.normal(size=(5,)).astype(np.float32)}},
                      "param_groups": [{"lr": 0.5, "params": [0, 1]}]},
        "step": 7,
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy()) if isinstance(tree, np.ndarray) else tree


def _case_manifests(tmp_path):
    rng = np.random.default_rng(0)
    tree_np = _tree(rng)
    tree = _to_torch(tree_np)
    wd = str(tmp_path / "manifests_case")
    cfg = tcfg_small()
    written = fault.write_manifest(wd, 3, tree, cfg, kind="emergency")
    loaded = j_fault.load_manifest(wd, 3)  # the JAX reader takes the port's manifest
    assert loaded == json.loads(json.dumps(written))
    assert loaded["schema"] == "ckpt_manifest/v1" and loaded["kind"] == "emergency"
    assert loaded["config_hash"] == fault.config_hash(cfg) and loaded["leaf_count"] == 7
    assert fault._leaf_records(tree) == j_fault._leaf_records(tree_np)  # keys, CRCs, shapes
    assert fault.verify_state(loaded, tree) == j_fault.verify_state(loaded, tree_np) == []
    # a bfloat16 leaf: the CRC of its bytes through a uint8 view
    bf = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    rec = fault._leaf_records({"w": bf})["['w']"]
    assert rec == {"crc32": j_fault._leaf_records({"w": bf.view(torch.uint8).numpy()})[
        "['w']"]["crc32"], "shape": [3], "dtype": "bfloat16"}
    # a corrupted leaf, a missing leaf (the count), an unexpected leaf
    bad = _to_torch(_tree(np.random.default_rng(0)))
    bad["model"]["conv.weight"][0, 0, 0, 0] += 1.0
    assert [p.split(" (")[0] for p in fault.verify_state(loaded, bad)] == [
        "checksum mismatch at ['model']['conv.weight']"]
    del bad["model"]["bn.running_var"]
    bad["extra"] = torch.zeros(1)
    problems = sorted(p.split(" (")[0] for p in fault.verify_state(loaded, bad))
    assert problems == ["checksum mismatch at ['model']['conv.weight']",
                        "missing leaf ['model']['bn.running_var']", "unexpected leaf ['extra']"]
    del bad["extra"]
    assert fault.verify_state(loaded, bad)[0] == "leaf count 6 != manifest 7"
    # the store: a step without a manifest restores unverified; pruning
    store = fault.CheckpointStore(wd, max_to_keep=2)
    for step in (1, 2, 3):
        store.save(step, tree)
        fault.publish_manifest_event(wd, step)
    assert store.all_steps() == [2, 3] and store.latest_step() == 3
    fault.write_manifest(wd, 1, tree)
    fault.prune_manifests(wd, store.all_steps())
    assert sorted(os.listdir(os.path.join(wd, "manifests"))) == ["3.json", "feed.jsonl"]
    feed = [json.loads(line) for line in open(fault.feed_path(wd))]
    assert [e["step"] for e in feed] == [1, 2, 3]
    logs = []
    res = fault.verified_restore(store, wd, step=2, log=logs.append)
    assert res.step == 2 and res.manifest is None and "no manifest" in logs[0]
    res = fault.verified_restore(store, wd, log=logs.append)
    assert res.step == 3 and res.manifest["kind"] == "emergency" and not res.discarded
    assert torch.equal(res.state["model"]["conv.weight"], tree["model"]["conv.weight"])
    with pytest.raises(ValueError, match="not found"):
        fault.verified_restore(store, wd, step=1)
    with pytest.raises(FileExistsError):
        store.save(3, tree)


def _case_async_writer():
    for mod in (j_async, None):
        writer = AsyncCheckpointWriter() if mod is None else mod.AsyncCheckpointWriter()
        release, order = threading.Event(), []

        def slow(step):
            def work():
                order.append(("start", step))
                assert release.wait(10)
                order.append(("end", step))
            return work

        assert writer.submit(1, slow(1)) is None and writer.in_flight
        t = threading.Thread(target=lambda: writer.submit(2, slow(2)))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and order == [("start", 1)]  # at most one in flight
        release.set()
        t.join(timeout=10)
        assert not t.is_alive() and writer.wait() is None
        assert order == [("start", 1), ("end", 1), ("start", 2), ("end", 2)]
        assert not writer.in_flight

        def fail():
            raise OSError("disk full")

        assert writer.submit(3, fail) is None
        err = writer.wait()  # surfaced once, at the next drain
        assert err[0] == 3 and isinstance(err[1], OSError) and writer.wait() is None
        writer.submit(4, fail)
        err = writer.submit(5, lambda: None)  # or at the next submit
        assert err[0] == 4 and writer.wait() is None


def _case_metric_logger(tmp_path):
    rows = []
    for mod, name in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        stream, path = io.StringIO(), str(tmp_path / f"{name}.jsonl")
        logger = mod(stream=stream)
        logger.jsonl_path = path  # as benchmarks/map_overfit.py sets it
        logger.log(5, {"loss": 0.25, "lr": np.float32(1e-4), "AP/cat": 0.5})
        logger.event("checkpoint_fallback", restored_step=4, discarded={6: "torn"})
        logger.log_epoch(1, 12.5)
        recs = [json.loads(line) for line in open(path)]
        for r in recs:
            r.pop("t", None)
        rows.append((stream.getvalue(), recs))
    assert rows[0] == rows[1]
    assert rows[0][1][0] == {"step": 5, "loss": 0.25, "lr": float(np.float32(1e-4)),
                             "AP/cat": 0.5}


def test_fault_host_parts_match_jax(tmp_path):
    _case_check_step_metrics()
    _case_skip_monitor()
    _case_shutdown()
    _case_manifests(tmp_path)
    _case_async_writer()
    _case_metric_logger(tmp_path)


# ------------------------------------------------------- kill and resume


def _quiet(trainer, path):
    trainer.logger = MetricLogger(stream=io.StringIO(), jsonl_path=str(path))
    return trainer


def _drive(trainer, poison_step=3, term_after=None):
    """Poison one sample of the batch of step ``poison_step`` with a NaN
    (the guarded update skips that step) and raise SIGTERM after step
    ``term_after``."""
    step_fn = trainer.train_one_batch

    def train_one_batch(batch, **kw):
        if trainer.state.step + 1 == poison_step:
            batch = dict(batch, image=batch["image"].copy())
            batch["image"][0, 3, 3, 0] = np.nan
        out = step_fn(batch, **kw)
        if trainer.state.step == term_after:
            signal.raise_signal(signal.SIGTERM)
        return out

    chunk_fn = trainer.train_chunk

    def train_chunk(batches, **kw):
        first = trainer.state.step + 1
        batches = list(batches)
        if first <= poison_step < first + len(batches):
            i = poison_step - first
            batches[i] = dict(batches[i], image=batches[i]["image"].copy())
            batches[i]["image"][0, 3, 3, 0] = np.nan
        return chunk_fn(batches, **kw)

    trainer.train_one_batch = train_one_batch
    trainer.train_chunk = train_chunk
    return trainer


def _rows(path):
    return [r for r in map(json.loads, open(path)) if "step" in r and "loss" in r]


def _flat_state(trainer):
    return dict(fault._leaves_with_path(trainer._host_state()))


def _assert_same_state(got, want, what):
    a, b = _flat_state(got), _flat_state(want)
    assert a.keys() == b.keys(), what
    for k in a:
        same = torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
        assert same, f"{what}: {k}"


def _case_log_chunk_rows(trainer):
    """The trainer's ``_log_chunk`` logs the row the JAX ``_log_chunk``
    chooses for each (first step, last step, log_every), with its lr."""
    rng = np.random.default_rng(0)
    for first, k, log_every in ((1, 4, 3), (4, 4, 3), (5, 2, 4), (9, 3, 2), (7, 2, 10)):
        step = first + k - 1
        metrics = {"loss": rng.uniform(size=k).astype(np.float32),
                   "skipped": np.zeros(k, np.float32)}
        rows = []
        for mod in ("port", "jax"):
            logged = []
            logger = types.SimpleNamespace(log=lambda s, r: logged.append((s, dict(r))))
            if mod == "port":
                trainer.logger = logger
                row = trainer._log_chunk(first, step, {k_: torch.from_numpy(v) for k_, v in
                                                       metrics.items()}, log_every)
            else:
                fake = types.SimpleNamespace(
                    tracer=j_spans.NULL_TRACER, logger=logger,
                    host_schedule=trainer.host_schedule,
                    skip_monitor=types.SimpleNamespace(drain=lambda: None))
                row = JTrainer._log_chunk(fake, first, step, metrics, log_every)
            rows.append((logged, None if row is None else {k_: float(v) for k_, v in
                                                           row.items()}))
        assert rows[0] == rows[1], (first, k, log_every)


def _events(path, kind):
    return [r for r in map(json.loads, open(path)) if r.get("event") == kind]


def test_kill_and_resume_bitwise(tmp_path):
    cfg = tcfg_small(n_epoch=3)
    ds = SyntheticDataset(cfg.data, length=6)  # 3 steps an epoch

    def make(workdir, log, **train):
        c = cfg.replace(train=dataclasses.replace(cfg.train, **train))
        return _quiet(Trainer(c, ds, device="cpu", workdir=str(workdir)), log)

    ref = _drive(make(tmp_path / "a", tmp_path / "a.jsonl"))
    ref.train(log_every=1)
    ref_rows = _rows(tmp_path / "a.jsonl")
    assert ref.state.step == 9 and [r["skipped"] for r in ref_rows] == [0, 0, 1] + [0] * 6
    assert int(ref.state.optimizer.count) == 8 and not os.path.exists(tmp_path / "a")

    # two steps a dispatch: the same state, bitwise, the poisoned step inside a chunk
    chunked = _drive(make(tmp_path / "k2", tmp_path / "k2.jsonl", steps_per_dispatch=2),
                     poison_step=2)
    chunked.train(log_every=1)
    once = _drive(make(tmp_path / "k1", tmp_path / "k1.jsonl"), poison_step=2)
    once.train(log_every=1)
    _assert_same_state(chunked, once, "steps_per_dispatch=2")
    assert [r["step"] for r in _rows(tmp_path / "k2.jsonl")] == [2, 3, 5, 6, 8, 9]
    assert [r["skipped"] for r in _rows(tmp_path / "k2.jsonl")] == [1, 0, 0, 0, 0, 0]
    _case_log_chunk_rows(chunked)

    for mode in ("sync", "async"):
        wd, log = tmp_path / mode, tmp_path / f"{mode}.jsonl"
        killed = _drive(make(wd, log, checkpoint_every_steps=2,
                             async_checkpoint=mode == "async"), term_after=5)
        before = signal.getsignal(signal.SIGTERM)
        with pytest.raises(fault.Preempted) as exc:
            killed.train(log_every=1)
        assert exc.value.step == 5 and signal.getsignal(signal.SIGTERM) == before
        assert [e["step"] for e in _events(log, "preempted")] == [5]
        manifest = fault.load_manifest(str(wd), 5)
        assert manifest["kind"] == "emergency" and manifest["writer"] == "sync"
        assert fault.load_manifest(str(wd), 4)["writer"] == mode
        assert fault.verify_state(manifest, fault.CheckpointStore(str(wd)).restore(5)) == []
        resumed = make(wd, log, checkpoint_every_steps=2, async_checkpoint=mode == "async")
        resumed.train(log_every=1, resume=True)
        _assert_same_state(resumed, ref, mode)
        rows = _rows(log)
        assert [r["step"] for r in rows] == list(range(1, 10))
        for r, w in zip(rows, ref_rows):
            assert {k: v for k, v in r.items() if k != "t"} == {
                k: v for k, v in w.items() if k != "t"} or np.isnan(r["loss"]), r["step"]
        assert fault.CheckpointStore(str(wd)).all_steps() == [5, 7, 9]

    wd, log = tmp_path / "sync", tmp_path / "sync.jsonl"
    # the newest verified weights, for inference
    model = load_eval_variables(cfg, str(wd), device="cpu")
    assert not model.training
    want = ref.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    # a torn latest step: fall back to the newest that verifies, delete the torn one
    state = wd / "9" / "state.pt"
    state.write_bytes(state.read_bytes()[:1000])
    fresh = make(wd, log)
    assert fresh.restore() == 7 and fresh.state.step == 7
    assert not (wd / "9").exists() and (wd / "7").exists()
    assert list(_events(log, "checkpoint_fallback")[-1]["discarded"]) == ["9"]
    # a torn step asked for by number raises; nothing is deleted
    state = wd / "7" / "state.pt"
    data = bytearray(state.read_bytes())
    data[len(data) // 2] ^= 0xFF
    state.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="step 7"):
        fresh.restore(step=7)
    assert (wd / "7").exists()
    # a scheduled save that fails is contained, an emergency one raises
    broken = make(tmp_path / "full", log)

    def disk_full(*args):
        raise OSError("disk full")

    broken.checkpoint_manager.save = disk_full
    assert broken.save() is False
    assert _events(log, "checkpoint_save_failed")[-1]["ckpt_kind"] == "scheduled"
    with pytest.raises(OSError, match="disk full"):
        broken.save(kind="emergency")
    broken._async_writer = AsyncCheckpointWriter()
    assert broken.save(step=3) is True  # submitted; the writer fails
    broken._drain_async_saves()
    assert _events(log, "checkpoint_save_failed")[-1]["writer"] == "async"
    # a generator's state restores only onto the device kind that saved it
    tree = ref._host_state()
    tree["generator_device"] = "cuda"
    with pytest.raises(ValueError, match="cuda generator .* cpu one"):
        fresh._load_state(tree)
    # the earlier torch.optim.Adam + LambdaLR layout is refused, saying so
    legacy = dict(tree, generator_device="cpu", scheduler={"last_epoch": 8},
                  optimizer={"state": {}, "param_groups": [{"lr": 1e-4}]})
    with pytest.raises(ValueError, match="torch.optim.Adam"):
        fresh._load_state(legacy)
    # the trainer's skip monitor records its escalation in the metric stream
    fresh.skip_monitor.on_escalate("nonfinite_escalation", consecutive=10)
    assert _events(log, "nonfinite_escalation")[-1]["consecutive"] == 10
    # no reference cycle keeps a dropped trainer (and its memory) alive
    ref = weakref.ref(fresh)
    del fresh
    assert ref() is None
