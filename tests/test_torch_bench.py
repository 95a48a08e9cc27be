"""The port's benchmark and telemetry against the JAX package's.

Two test ids, each a loop of cases (each id costs the fast tier's budget):

- the benchmark: the train line of ``benchmark.main`` (with a profiler
  capture) and the eval line of ``_measure_eval`` at the CLI tests' tiny
  config hold the JAX lines' keys, metric names and breakdown keys, and so
  do the lines of ``voc_resnet50_fpn``'s wiring (ResNet18) there, whose FPN
  neck's FLOP count is within [0.97, 1.0] of JAX's (XLA also counts the
  top-down adds); ``compute_mfu`` and the peak table; the
  watchdog's error line; the FLOP count of one flagship step (600x600, b1)
  within [0.95, 1.0] of JAX's HloCostAnalysis count, and the ResNet tail's
  forward and forward+backward within 1% of it;
- telemetry: one scripted span sequence through both ``SpanTracer``s, a
  stall and an incident through both ``StallWatchdog``s, ``summarize_run``
  on one run directory, and a port ``Trainer(telemetry_dir=...)`` run
  (96x96, 6 steps, ``log_every=3``, one save) against the JAX trainer's
  files and span names, bitwise equal in state to the same run without
  telemetry; the host reads the card where the JAX trainer does: the
  sequence of ``step/dispatch``, ``step/sync`` and ``fault/skip_drain``
  spans (``step/sync`` at the log boundaries and the epoch's end) is the
  JAX trace's.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from replication_faster_rcnn_tpu import benchmark as j_bench
from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.models.fpn import FPNNeck as JFPNNeck
from replication_faster_rcnn_tpu.models.resnet import ResNetTail as JResNetTail
from replication_faster_rcnn_tpu.telemetry import mfu as j_mfu
from replication_faster_rcnn_tpu.telemetry import report as j_report
from replication_faster_rcnn_tpu.telemetry import spans as j_spans
from replication_faster_rcnn_tpu.telemetry import watchdog as j_watchdog
from replication_faster_rcnn_tpu.train.trainer import Trainer as JTrainer
from replication_faster_rcnn_tpu_torch import benchmark
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.models.fpn import FPNNeck
from replication_faster_rcnn_tpu_torch.models.resnet import ResNetTail
from replication_faster_rcnn_tpu_torch.telemetry import mfu, report, spans, watchdog
from replication_faster_rcnn_tpu_torch.train import fault
from replication_faster_rcnn_tpu_torch.train.trainer import Trainer
from replication_faster_rcnn_tpu_torch.train.train_step import create_train_state, make_train_step
from replication_faster_rcnn_tpu_torch.utils import profiling

CPU_PEAK = "1e11"  # FRCNN_CPU_PEAK_FLOPS on both sides: a fixed MFU basis


def _tiny(mod):
    """``tests/test_cli.py``'s bench config: 64x64, proposals 128 -> 32, batch 2,
    computed in float32 (bfloat16 convolutions cost the CPU seconds a step,
    and no assert on these lines reads the compute dtype). The bench's
    bfloat16 step is held against JAX by the flagship FLOP count in
    ``test_benchmark_matches_jax``: one step of ``_flagship_cfg`` (600x600,
    b1, bfloat16) through ``benchmark._step_flops``."""
    cfg = mod.get_config("voc_resnet18")
    cfg = cfg.replace(
        data=mod.DataConfig(dataset="synthetic", image_size=(64, 64), max_boxes=8),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        proposals=mod.ProposalConfig(pre_nms_train=128, post_nms_train=32),
        train=mod.TrainConfig(batch_size=2),
    )
    return cfg.replace(mesh=mod.MeshConfig(num_data=1)) if mod is jconfig else cfg


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_benchmark_matches_jax(monkeypatch, capsys, tmp_path):
    for var in ("BENCH_MODE", "BENCH_BATCH", "BENCH_EVAL_BATCH", "BENCH_BREAKDOWN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BENCH_STEPS", "2")
    monkeypatch.setenv("FRCNN_CPU_PEAK_FLOPS", CPU_PEAK)
    # the port's lines take one warm-up step, one stage-timed step and one
    # captured step here (3, 5 and 3 on the card): a CPU step of the tiny
    # config costs seconds, and no assert reads the repetitions
    for name in ("WARMUP_STEPS", "STAGE_STEPS", "TRACE_STEPS"):
        monkeypatch.setattr(benchmark, name, 1)

    # the lines: same keys, metric names and breakdown keys
    j_bench._measure(_tiny(jconfig))
    j_train = _last_line(capsys)
    j_bench._measure_eval(_tiny(jconfig))
    j_eval = _last_line(capsys)
    # the entry point, with the capture that BENCH_PROFILE_DIR asks for
    got = benchmark.main(_tiny(tconfig), profile_dir=str(tmp_path / "prof"), device="cpu")
    t_train = _last_line(capsys)
    assert t_train == json.loads(json.dumps(got))
    assert t_train.pop("trace") == "ok" and profiling.has_device_trace(str(tmp_path / "prof"))
    benchmark._measure_eval(_tiny(tconfig), device="cpu")
    t_eval = _last_line(capsys)
    assert list(t_train) == list(j_train) and list(t_eval) == list(j_eval)
    assert t_train["metric"] == j_train["metric"] == "train_images_per_sec_64x64"
    assert t_eval["metric"] == j_eval["metric"] == "eval_images_per_sec_64x64"
    assert set(t_train["breakdown"]) == set(j_train["breakdown"]), (
        t_train["breakdown"], j_train["breakdown"])
    assert t_train["value"] > 0 and t_train["flops_per_step"] > 0 and t_train["mfu"] > 0
    assert t_train["mfu_basis"] == j_train["mfu_basis"] == "cpu_measured_matmul"
    assert t_train["vs_baseline"] > 0
    bd = t_train["breakdown"]
    assert bd["trunk_ms"] > 0 and bd["step_ms"] > 0
    assert bd["backward_update_ms"] == pytest.approx(
        bd["backward_ms"] + bd["opt_update_ms"], abs=0.05)
    assert t_eval["value"] > 0 and t_eval["vs_baseline"] is None
    assert (t_eval["batch_size"], t_eval["note"]) == (2, j_eval["note"])

    # voc_resnet50_fpn's wiring (ResNet18 for speed) at the tiny config: the
    # JAX lines' keys and breakdown keys; the trunk stage times the list of
    # levels; the FLOP count holds the neck's convolutions as XLA counts them
    fpn = _tiny(tconfig).replace(model=dataclasses.replace(
        tconfig.get_config("voc_resnet50_fpn").model, backbone="resnet18",
        compute_dtype="float32"),
        anchors=tconfig.get_config("voc_resnet50_fpn").anchors)
    benchmark.main(fpn, device="cpu")
    t_fpn = _last_line(capsys)
    benchmark._measure_eval(fpn, device="cpu")
    t_fpn_eval = _last_line(capsys)
    assert list(t_fpn) == list(j_train) and list(t_fpn_eval) == list(j_eval)
    assert set(t_fpn["breakdown"]) == set(j_train["breakdown"])
    assert t_fpn["metric"] == j_train["metric"] and t_fpn_eval["metric"] == j_eval["metric"]
    assert t_fpn["breakdown"]["trunk_ms"] > 0 and t_fpn["mfu"] > 0 and t_fpn_eval["value"] > 0
    feats = [jnp.zeros((2, 16 // 2**i, 16 // 2**i, c), jnp.float32)
             for i, c in enumerate((64, 128, 256, 512))]
    jneck = JFPNNeck(256, jnp.float32)
    nv = jneck.init(jax.random.PRNGKey(0), feats)
    j_neck = j_bench.lowered_cost(lambda p, f: sum(x.sum() for x in jneck.apply(p, f)), nv,
                                  feats)["flops"]
    neck = FPNNeck((64, 128, 256, 512), 256, device="cpu")
    t_neck = benchmark.count_flops(lambda: neck([torch.zeros(x.shape).permute(0, 3, 1, 2)
                                                 for x in feats]))
    assert 0.97 <= t_neck / j_neck <= 1.0, (t_neck, j_neck)
    assert t_fpn["flops_per_step"] > 3 * t_neck

    # MFU arithmetic and the peak bases
    for case in ((2.1e12, 4.0, 989.4e12), (1e9, 2.5, 1e11), (0.0, 1.0, 1e11),
                 (1e9, None, 1e11), (1e9, 1.0, None)):
        assert mfu.compute_mfu(*case) == j_mfu.compute_mfu(*case), case
    assert mfu.peak_flops_per_sec(1, "cpu") == j_mfu.peak_flops_per_sec(1) == (
        float(CPU_PEAK), "cpu_measured_matmul")
    assert mfu.gpu_peak_flops_per_sec("NVIDIA H100 80GB HBM3", 1) == 989.4e12
    assert mfu.gpu_peak_flops_per_sec("NVIDIA H100 PCIe", 2) == 2 * 756e12
    assert mfu.gpu_peak_flops_per_sec("NVIDIA A100-SXM4-80GB", 1) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name, want in (("NVIDIA H100 80GB HBM3", (989.4e12, "h100_datasheet_bf16_dense")),
                       ("NVIDIA L4", (None, None))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, n=name: n)
        assert mfu.peak_flops_per_sec() == want, name

    # the entry point runs on the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main()

    # the watchdog's error line (os._exit recorded instead of taken)
    codes = []
    monkeypatch.setattr(os, "_exit", codes.append)
    monkeypatch.setenv("BENCH_WATCHDOG_S", "0.05")
    benchmark._arm_watchdog().join(10)
    t_wedge = _last_line(capsys)
    j_bench._wedge_exit("a reason")
    j_wedge = _last_line(capsys)
    assert codes == [2, 2] and list(t_wedge) == list(j_wedge)
    assert t_wedge["value"] == 0.0 and "watchdog" in t_wedge["error"]

    # FLOPs of one flagship train step (600x600, b1): in-bounds convolution
    # taps as XLA counts them. Measured: 135.22 against JAX's 139.33 GFLOP,
    # a ratio of 0.9705 (elementwise work, which XLA counts, is not); the
    # stock full-window formulas read 167.51 (1.20x).
    j_flops = j_bench._flops_of_config(
        j_bench._flagship_cfg(1).replace(train=jconfig.TrainConfig(batch_size=1)))
    cfg = benchmark._flagship_cfg().replace(train=tconfig.TrainConfig(batch_size=1))
    assert cfg.model.compute_dtype == "bfloat16"  # the bench's bfloat16 step, counted
    state = create_train_state(cfg, 100, "cpu", 0)
    step = make_train_step(cfg)
    batch = benchmark._synthetic_batch(cfg, 1)
    dbatch = {k: torch.from_numpy(batch[k]) for k in ("image", "boxes", "labels", "mask")}
    # one step counted both ways: the in-bounds count inside PyTorch's stock
    # full-window formulas (each mode sees every operator)
    with FlopCounterMode(display=False) as stock:
        t_flops = benchmark._step_flops(step, state, dbatch)
    assert 0.95 <= t_flops / j_flops <= 1.0, (t_flops, j_flops)
    assert stock.get_total_flops() / j_flops > 1.15, (stock.get_total_flops(), j_flops)

    # the ResNet tail alone on the 128 7x7 crops of an image: forward and
    # forward+backward (gradients of the parameters and the crops)
    x = jnp.zeros((128, 7, 7, 256), jnp.float32)
    jtail = JResNetTail("resnet18", jnp.float32)
    v = jtail.init(jax.random.PRNGKey(0), x, True)

    def j_fwd(params, x):
        out, _ = jtail.apply({"params": params, "batch_stats": v["batch_stats"]}, x, True,
                             mutable=["batch_stats"])
        return out.sum()

    j_tail = (j_bench.lowered_cost(j_fwd, v["params"], x)["flops"],
              j_bench.lowered_cost(jax.grad(j_fwd, argnums=(0, 1)), v["params"], x)["flops"])
    tail = ResNetTail("resnet18", device="cpu").train()
    xt = torch.zeros((128, 7, 7, 256), requires_grad=True)
    t_tail = (benchmark.count_flops(lambda: tail(xt)),
              benchmark.count_flops(lambda: tail(xt).sum().backward()))
    for got_f, want_f in zip(t_tail, j_tail):
        assert abs(got_f / want_f - 1) < 0.01, (t_tail, j_tail)


def _strip_trace(doc):
    """A tracer's dict without its clocks (timestamps, durations, start)."""
    other = {k: v for k, v in doc["otherData"].items() if k != "start_unix_time"}
    events = [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
              for ev in doc["traceEvents"]]
    return {**doc, "otherData": other, "traceEvents": events}


def _span_script(tracer):
    with tracer.span("step/dispatch", cat="step", steps=1):
        with tracer.span("data/device_put", cat="data", feed="loader"):
            pass
        tracer.instant("mark", k="v")
    tracer.counter("loader/queue_depth", 3)
    tracer.complete("serve/queue_wait", 10.0, 5.0, cat="serve", replica="r0")
    for i in range(6):  # past max_events: counted as dropped
        with tracer.span(f"extra/{i}"):
            pass


def _stall_and_incident(wd_mod, spans_mod, run_dir):
    tracer = spans_mod.SpanTracer()
    with tracer.span("step/dispatch", cat="step"):
        pass
    wd = wd_mod.StallWatchdog(
        timeout_s=0.05, snapshot_path=str(run_dir / "watchdog.jsonl"),
        progress_path=str(run_dir / "progress.json"), tracer=tracer,
        providers={"depth": lambda: 2, "broken": lambda: 1 / 0}, poll_s=0.01)
    wd.beat(step=1, phase="train")
    wd.start()
    deadline = time.monotonic() + 30
    # the thread counts the stall before it takes the snapshot: wait for that
    while wd.last_snapshot is None and time.monotonic() < deadline:
        time.sleep(0.01)
    # stopped before the main thread's incident and beat, so that no second
    # stall can fire on a loaded machine before the recovery is recorded
    wd.stop()
    stall = wd.last_snapshot
    wd.incident("preempted", step=1, reason="SIGTERM")
    wd.beat(step=2, phase="train")
    rows = [json.loads(line) for line in open(run_dir / "watchdog.jsonl")]
    return wd, stall, rows, json.load(open(run_dir / "progress.json"))


def _small(mod, **train):
    cfg = mod.get_config("voc_resnet18")
    cfg = cfg.replace(
        data=mod.DataConfig(dataset="synthetic", image_size=(96, 96), max_boxes=4),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        proposals=mod.ProposalConfig(pre_nms_train=192, post_nms_train=48),
        rpn_targets=mod.RPNTargetConfig(n_sample=64),
        roi_targets=mod.ROITargetConfig(n_sample=16),
        train=mod.TrainConfig(batch_size=2, n_epoch=1, checkpoint_every_epochs=1, **train),
    )
    return cfg.replace(mesh=mod.MeshConfig(num_data=1)) if mod is jconfig else cfg


def _span_names(run_dir):
    events = report.load_trace_events(os.path.join(run_dir, "trace.json"))
    return {ev["name"] for ev in events if ev["ph"] == "X"}


def _sync_sequence(run_dir):
    """The run's dispatch spans and host reads, in order (the epoch's sync
    marked)."""
    events = report.load_trace_events(os.path.join(run_dir, "trace.json"))
    spans_ = sorted((ev["ts"], ev["name"], (ev.get("args") or {}).get("boundary"))
                    for ev in events if ev["ph"] == "X"
                    and ev["name"] in ("step/dispatch", "step/sync", "fault/skip_drain"))
    return [name + (f":{b}" if b else "") for _, name, b in spans_]


def test_telemetry_matches_jax(tmp_path, capsys):
    try:
        # one span sequence through both tracers, overflow included
        docs = []
        for mod in (j_spans, spans):
            mod.set_tracer(None)  # an earlier test's trainer may have left one
            tracer = mod.SpanTracer(str(tmp_path / f"{mod.__name__}.json"), max_events=6, rank=1)
            assert mod.set_tracer(tracer) is None and mod.current_tracer() is tracer
            _span_script(mod.current_tracer())
            assert tracer.last_span["name"] == "extra/5" and tracer.last_span["age_s"] >= 0
            assert mod.set_tracer(None) is tracer and mod.current_tracer() is mod.NULL_TRACER
            with mod.NULL_TRACER.span("x"):
                mod.NULL_TRACER.counter("c", 1)
            tracer.flush()
            docs.append(_strip_trace(json.load(open(tracer.path))))
        assert docs[0] == docs[1] and docs[1]["otherData"]["dropped_events"] == 5

        # a stall, a fault incident and the recovery through both watchdogs
        results = []
        for wd_mod, spans_mod in ((j_watchdog, j_spans), (watchdog, spans)):
            run_dir = tmp_path / f"wd_{wd_mod.__name__}"
            run_dir.mkdir()
            results.append(_stall_and_incident(wd_mod, spans_mod, run_dir))
        incidents = run_dir / "watchdog.jsonl"  # the port's
        (j_wd, j_stall, j_rows, j_prog), (t_wd, t_stall, t_rows, t_prog) = results
        assert (t_wd.fired_count, t_wd.recovered_count) == (j_wd.fired_count,
                                                             j_wd.recovered_count) == (1, 1)
        assert set(t_stall) == set(j_stall) and "threads" in t_stall
        assert t_stall["gauges"] == j_stall["gauges"] and t_stall["gauges"]["depth"] == 2
        assert t_stall["last_span"]["name"] == j_stall["last_span"]["name"] == "step/dispatch"
        assert [r["kind"] for r in t_rows] == [r["kind"] for r in j_rows] == [
            "stall", "preempted", "recovered"]
        assert [set(r) for r in t_rows] == [set(r) for r in j_rows]
        assert set(t_prog) == set(j_prog) and t_prog["step"] == 2

        # the port's trainer with telemetry (96x96, 3 steps, one save at the
        # end of the epoch) against the same run without it and the JAX run
        cfg = _small(tconfig)
        ds = SyntheticDataset(cfg.data, length=12)
        tel = tmp_path / "tel"
        with_tel = Trainer(cfg, ds, device="cpu", workdir=str(tmp_path / "a"),
                           telemetry_dir=str(tel))
        assert spans.current_tracer() is with_tel.tracer
        with_tel.train(log_every=3)
        spans.set_tracer(None)
        plain = Trainer(cfg, ds, device="cpu", workdir=str(tmp_path / "b"))
        assert plain.tracer is spans.NULL_TRACER and plain.watchdog is None
        plain.train(log_every=3)
        a = dict(fault._leaves_with_path(with_tel._host_state()))
        b = dict(fault._leaves_with_path(plain._host_state()))
        assert a.keys() == b.keys() and with_tel.state.step == 6
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                    else a[k] == b[k]), k
        assert not any(t.name == "telemetry-watchdog" for t in threading.enumerate())

        jcfg = _small(jconfig)
        j_tel = tmp_path / "j_tel"
        JTrainer(jcfg, workdir=str(tmp_path / "j"), dataset=JSyntheticDataset(jcfg.data, length=12),
                 telemetry_dir=str(j_tel)).train(log_every=3)
        j_spans.set_tracer(None)
        assert sorted(os.listdir(tel)) == sorted(os.listdir(j_tel)) == [
            "metrics.jsonl", "progress.json", "trace.json"]
        t_names, j_names = _span_names(tel), _span_names(j_tel)
        # the port's save copies the state to the host first (state/host_fetch);
        # orbax writes the device arrays
        assert j_names <= t_names and t_names - j_names == {"state/host_fetch"}, (t_names, j_names)
        assert {"step/dispatch", "step/sync", "data/fetch", "data/device_put", "data/build",
                "checkpoint/save", "checkpoint/manifest"} <= t_names
        # host reads where the JAX trainer has them: after steps 3 and 6 and
        # at the epoch's end, never between log boundaries
        host_reads = [_sync_sequence(d) for d in (tel, j_tel)]
        assert host_reads[0] == host_reads[1] == (
            (["step/dispatch"] * 3 + ["step/sync"] + ["fault/skip_drain"] * 3) * 2
            + ["step/sync:epoch"]), host_reads
        rows = report.load_jsonl(str(tel / "metrics.jsonl"))
        assert [r["step"] for r in rows if "loss" in r] == [3, 6]
        assert json.load(open(tel / "progress.json"))["step"] == 6
        # a caller outside train(): restore, then flush_telemetry writes the trace
        restored = Trainer(cfg, ds, device="cpu", workdir=str(tmp_path / "a"),
                           telemetry_dir=str(tmp_path / "tel_restore"))
        assert restored.restore() == 6
        restored.flush_telemetry()
        assert _span_names(tmp_path / "tel_restore") == {"checkpoint/restore"}
        spans.set_tracer(None)

        # the report on one run directory: the port's trace and metrics, the
        # watchdog's incidents
        (tel / "watchdog.jsonl").write_text(incidents.read_text())
        t_sum, j_sum = report.summarize_run(str(tel)), j_report.summarize_run(str(tel))
        assert t_sum == j_sum and t_sum["incidents"]["stalls"] == 1
        assert report.format_report(t_sum) == j_report.format_report(j_sum)
        assert {r["name"] for r in t_sum["phases"]} == t_names
        empty = tmp_path / "empty"
        empty.mkdir()
        assert report.format_report(report.summarize_run(str(empty))) == j_report.format_report(
            j_report.summarize_run(str(empty)))
    finally:
        spans.set_tracer(None)
        j_spans.set_tracer(None)
