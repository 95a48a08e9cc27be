"""Parity of the PyTorch port's serving stack with the JAX package's, on the
CPU at 32x32: the engine (detections, ``submit_path``, hot-swap), the HTTP
server, the pure host modules (metrics, SLO burn rate, trace context,
overload, the deadline controller, failpoints, the batcher's hooks) and the
load generator. One JAX engine and one port engine, module-scoped, serve the
same bridged weights (``voc12_resnet18_align``, float32 compute, bucket
32x32, batch sizes 1 and 2).

Tolerances, with their reasons:

* Detections: boxes to 1e-3 px, scores to 1e-6, classes and valid equal —
  the decode's tolerance (``tests/test_torch_eval.py``, module docstring):
  XLA:CPU and oneDNN sum the convolutions in other orders.
* HTTP: status codes, JSON keys and metric names equal.
* Pure modules: equal outputs (plain Python float math on scripted inputs
  and an injected clock).
* Load generator: equal summary keys and counts (times differ run to run).
"""

import dataclasses
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import json
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.faultlib import failpoints as j_failpoints
from replication_faster_rcnn_tpu.serving import loadgen as j_loadgen
from replication_faster_rcnn_tpu.serving import overload as j_overload
from replication_faster_rcnn_tpu.serving.batcher import MicroBatcher as JMicroBatcher
from replication_faster_rcnn_tpu.serving.engine import InferenceEngine as JInferenceEngine
from replication_faster_rcnn_tpu.serving.server import make_server as j_make_server
from replication_faster_rcnn_tpu.serving.slo import DeadlineController as JDeadlineController
from replication_faster_rcnn_tpu.telemetry import metrics as j_metrics
from replication_faster_rcnn_tpu.telemetry import slo_burn as j_slo_burn
from replication_faster_rcnn_tpu.telemetry import tracecontext as j_tracecontext
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.serving import loadgen, overload
from replication_faster_rcnn_tpu_torch.serving.batcher import MicroBatcher
from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
from replication_faster_rcnn_tpu_torch.serving.server import make_server
from replication_faster_rcnn_tpu_torch.serving.slo import DeadlineController
from replication_faster_rcnn_tpu_torch.telemetry import metrics, slo_burn, tracecontext
from tests.test_torch_model import _randomise

SIZE = (32, 32)
# the decode's detection tolerance (tests/test_torch_eval.py)
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-6


def _cfg(mod):
    cfg = mod.get_config("voc12_resnet18_align")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=SIZE),
        serving=dataclasses.replace(
            cfg.serving, resolutions=(SIZE,), batch_sizes=(1, 2), params_dtype="float32",
            max_delay_ms=100.0, queue_depth=2, request_timeout_s=60.0),
    )


def _variables(raw, seed):
    """``raw`` (JAX variables of ``voc12_resnet18_align`` at 32x32) with
    statistics and biases drawn from ``seed`` and the RPN/head tempered (as
    ``test_torch_eval.py``), so the decode keeps several detections an
    image."""
    variables = _randomise(raw, np.random.default_rng(seed))
    for layer in (variables["params"]["head"]["cls"], variables["params"]["head"]["reg"],
                  *variables["params"]["rpn"].values()):
        layer["kernel"] = (layer["kernel"] * 0.1).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def engines():
    # the port's seeded init in the flax layout (a JAX init would compile for
    # ~15 s on the CPU); the bridge round trip is bitwise (test_torch_serving.py)
    raw = to_flax_variables(build_model(_cfg(tconfig), device="cpu", seed=0).state_dict())
    variables = [_variables(raw, 0), _variables(raw, 1)]
    jeng = JInferenceEngine(_cfg(jconfig), None,
                            jax.tree_util.tree_map(jnp.asarray, variables[0]))
    teng = InferenceEngine(_cfg(tconfig), device="cpu",
                           state_dict=from_flax_variables(variables[0]))
    # warm both batch sizes (the JAX engine compiles its two programs here),
    # so later flushes finish well inside request_timeout_s
    warm = _images(np.random.default_rng(9), [(32, 32)] * 2)
    for eng in (jeng, teng):
        eng.submit(warm[0]).result(timeout=300)
        [f.result(timeout=300) for f in [eng.submit(img) for img in warm]]
    yield jeng, teng, variables
    jeng.close()
    teng.close()


def _images(rng, shapes):
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def _assert_detections(got, want, what):
    np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=what)
    np.testing.assert_array_equal(got["classes"], want["classes"], err_msg=what)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=BOX_ATOL, err_msg=what)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_ATOL,
                               err_msg=what)


def _write_pngs(tmp_path, images):
    from PIL import Image

    paths = []
    for i, img in enumerate(images):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(img).save(path)
        paths.append(str(path))
    return paths


def test_engine_and_hot_swap_match_jax(engines, tmp_path):
    """Detections on uint8 images and on ``submit_path`` files; then a swap
    to a second seeded version: the request admitted before it is answered
    by the old weights, the one after by the new, on both sides; both report
    the same versions; a state of the wrong structure raises before
    anything changes."""
    jeng, teng, variables = engines
    rng = np.random.default_rng(0)
    images = _images(rng, [(32, 32), (20, 30), (32, 17), (45, 40)])
    got = teng.predict(images)
    want = [jeng.submit(img).result(timeout=120) for img in images]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_detections(g, w, f"image {i}")
    assert sum(int(g["valid"].sum()) for g in got) >= 4
    paths = _write_pngs(tmp_path, images[:2])
    for i, (g, w) in enumerate(zip(teng.predict_paths(paths), jeng.predict_paths(paths))):
        _assert_detections(g, w, f"path {i}")

    # hot-swap: one request waits in the batcher (max_delay 100 ms) while the
    # engine swaps; the next is admitted under the new version
    for eng, new in ((jeng, jax.tree_util.tree_map(jnp.asarray, variables[1])),
                     (teng, from_flax_variables(variables[1]))):
        before = eng.submit(images[0])
        assert eng.swap_params(new, "1") == "0"
        after = eng.submit(images[0])
        eng.results = (before.result(timeout=120), after.result(timeout=120))
    for (g, w), what in zip(zip(teng.results, jeng.results), ("admitted before", "after")):
        _assert_detections(g, w, f"request {what} the swap")
    _assert_detections(teng.results[0], got[0], "the old version's answer")
    assert not np.allclose(teng.results[1]["scores"], got[0]["scores"])
    assert teng.model_version == jeng.model_version == "1"
    assert teng.resident_versions() == jeng.resident_versions() == {"0": False, "1": True}
    assert [k[0] for k, _ in teng.flush_log[-2:]] == ["0", "1"]

    # a state missing a leaf: both raise, nothing changes
    bad = from_flax_variables(variables[0])
    bad.pop(next(iter(bad)))
    jbad = jax.tree_util.tree_map(jnp.asarray, variables[0])
    jbad["params"] = {k: v for k, v in jbad["params"].items() if k != "head"}
    with pytest.raises(ValueError, match="wrong model/config"):
        teng.swap_params(bad, "2")
    with pytest.raises(ValueError, match="wrong model/config"):
        jeng.swap_params(jbad, "2")
    wrong = from_flax_variables(variables[0])
    key = next(k for k in wrong if wrong[k].dim() == 4)
    wrong[key] = wrong[key][:1]
    with pytest.raises(ValueError, match="wrong model/config"):
        teng.swap_params(wrong, "2")
    assert teng.resident_versions() == jeng.resident_versions() == {"0": False, "1": True}
    assert teng.model_version == jeng.model_version == "1"


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, headers, raw = resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, dict(e.headers), e.read().decode()
    try:
        return status, headers, json.loads(raw)
    except ValueError:
        return status, headers, raw


def _shape(value):
    """The JSON's key structure (lists by their first element)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(value[0])] if value else []
    return type(value).__name__


def _metric_names(text):
    return sorted({line.split("{")[0].split(" ")[0] for line in text.splitlines()
                   if line and not line.startswith("#")})


def _run_contract(make, engine, fp, paths, tmp_path):
    """Every request of the HTTP contract against one server; returns
    (status, key structure) per request."""
    server = make(engine, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out, config = {}, engine.config
    try:
        status, _, body = _http(f"{base}/predict", {"paths": paths, "score_thresh": 0.0})
        out["predict"] = (status, sorted(body), _shape(body["detections"][paths[0]]))
        status, _, body = _http(f"{base}/predict", {"path": str(tmp_path / "missing.png")})
        out["bad_path"] = (status, sorted(body))
        status, _, body = _http(f"{base}/predict", {})
        out["no_path"] = (status, sorted(body))
        status, _, body = _http(f"{base}/healthz")
        out["healthz"] = (status, sorted(body))
        status, _, body = _http(f"{base}/stats")
        out["stats"] = (status, sorted(body), body["schema"], sorted(body["stats"]),
                        sorted(body["slo"]), sorted(body["metrics"]))
        status, headers, body = _http(f"{base}/metrics")
        out["metrics"] = (status, headers["Content-Type"], _metric_names(body))
        status, _, body = _http(f"{base}/swap", {"version": "2"})
        out["swap_unset"] = (status, sorted(body))
        server.swap_handler = lambda version: engine.model_version
        status, _, body = _http(f"{base}/swap", {"version": "2"})
        out["swap"] = (status, sorted(body))
        status, _, body = _http(f"{base}/nope")
        out["unknown"] = (status, sorted(body))

        # a flush held 2.5 s by a failpoint: the queue (depth 2) fills and
        # sheds (503 + Retry-After); the held requests outlive a 1 s
        # request_timeout_s (504). The engine and the handler read the
        # deadline from engine.config at each request.
        config = engine.config
        engine.config = config.replace(serving=dataclasses.replace(
            config.serving, request_timeout_s=1.0))
        fp.configure("batcher.flush:delay:1.0:0:2500:1")
        held = {}

        def post(k):
            held[k] = _http(f"{base}/predict", {"path": paths[0]})

        threads = [threading.Thread(target=post, args=(0,))]
        threads[0].start()
        deadline = time.time() + 30
        while fp.site_hits().get("batcher.flush", 0) < 1:
            assert time.time() < deadline
            time.sleep(0.005)
        for k in (1, 2):
            threads.append(threading.Thread(target=post, args=(k,)))
            threads[-1].start()
        while engine.queue_depth() < 2:
            assert time.time() < deadline
            time.sleep(0.005)
        status, headers, body = _http(f"{base}/predict", {"path": paths[0]})
        out["full_queue"] = (status, "Retry-After" in headers, sorted(body))
        for t in threads:
            t.join(60)
        out["held"] = sorted((held[k][0], sorted(held[k][2])) for k in held)
    finally:
        fp.disarm()
        engine.config = config
        server.shutdown()
        server.server_close()
    return out


def test_http_and_serve_match_jax(engines, tmp_path, capsys, monkeypatch):
    """Both HTTP servers on port 0 answer the same requests with the same
    status codes, JSON keys and metric names; then ``python -m
    replication_faster_rcnn_tpu_torch serve`` on the CPU: start-up JSON, one
    /predict, and a SIGTERM drain that exits 0; then the other subcommands
    in-process (:func:`_cli_matches_jax`)."""
    jeng, teng, _ = engines
    paths = _write_pngs(tmp_path, _images(np.random.default_rng(1), [(32, 32), (24, 30)]))
    want = _run_contract(j_make_server, jeng, j_failpoints, paths, tmp_path)
    got = _run_contract(make_server, teng, failpoints, paths, tmp_path)
    assert got == want
    assert got["predict"][0] == 200 and got["full_queue"][:2] == (503, True)
    assert [s for s, _ in got["held"]] == [504, 504, 504]
    assert (got["bad_path"][0], got["swap_unset"][0], got["swap"][0]) == (400, 501, 200)

    cmd = [sys.executable, "-m", "replication_faster_rcnn_tpu_torch", "serve", "--device", "cpu",
           "--config", "voc12_resnet18_align", "--image-size", "32", "--resolutions", "32x32",
           "--bucket-batch-sizes", "1", "--workdir", str(tmp_path / "none"), "--port", "0",
           "--replica-id", "r0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(240, proc.kill)  # a hung server fails the test, never the run
    watchdog.start()
    try:
        lines = []
        while not (lines and lines[-1].startswith("serving on ")):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            lines.append(line)
        startup = json.loads("".join(lines[:-1]))
        assert startup["buckets"] == [[32, 32]] and startup["device"] == "cpu"
        assert startup["model_version"] == "0" and startup["params_dtype"] == "bfloat16"
        url = lines[-1].split()[2].rstrip("/")
        status, _, body = _http(f"{url}/predict", {"path": paths[0]})
        assert status == 200 and paths[0] in body["detections"]
        proc.send_signal(signal.SIGTERM)
        for _ in range(200):
            status, _, health = _http(f"{url}/healthz")
            if health["draining"]:
                break
            time.sleep(0.01)
        assert health["draining"] and health["replica_id"] == "r0"
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _cli_matches_jax(tmp_path, capsys, monkeypatch, engines, paths)


CLI_COMMON = ["--config", "voc12_resnet18_align", "--device", "cpu", "--dataset", "synthetic",
              "--image-size", "96"]


def _cli(main, argv, capsys):
    """(exit code, stdout) of one in-process command (argparse errors exit 2)."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr()


def _trace_dir(root):
    """Two replicas' traces (``trace.json`` and ``trace.rank2.json``) of one
    request: a fleet attempt and the replica's request, queue wait and
    dispatch under one trace id."""
    tid = "ab" * 16
    spans = [("fleet/request", 0, 900, "f1", None, {"ok": True}),
             ("fleet/attempt", 10, 880, "f2", "f1", {"replica": "r1"}),
             ("serve/request", 40, 800, "s1", "f2", {"replica": "r1"}),
             ("serve/queue_wait", 40, 300, "s2", "s1", {"key": "32x32"}),
             ("serve/dispatch", 350, 480, "s3", "s1", {"program": "serve_32x32_b1"})]
    root.mkdir()
    for name, rows in (("trace.json", spans[:2]), ("trace.rank2.json", spans[2:])):
        events = [{"ph": "X", "name": n, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
                   "args": {"trace_id": tid, "span_id": sid, "parent_span_id": parent, **extra}}
                  for n, ts, dur, sid, parent, extra in rows]
        (root / name).write_text(json.dumps({"traceEvents": events}))
    return tid


def _model_knob_flags(cli, jcli, capsys):
    """``--backbone resnext50_32x4d --remat --frozen-bn`` and ``--norm
    group`` (the ported model knobs and backbones) give the config JAX's
    ``_build_config`` gives, over the port's fields; ``--norm group
    --frozen-bn`` is refused with JAX's error."""
    def built(mod, argv):
        seen = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "cmd_train", lambda args: seen.append(mod._build_config(args)) or 0)
            rc, out = _cli(mod.main, ["train", "--config", "voc12_resnet18_align", *argv],
                           capsys)
        assert rc == 0 and len(seen) == 1, (argv, out.err)
        return seen[0]

    for argv in (["--backbone", "resnext50_32x4d", "--remat", "--frozen-bn"],
                 ["--norm", "group"], ["--backbone", "wide_resnet101_2", "--norm", "batch"]):
        got, want = built(cli, argv), built(jcli, argv)
        for section in dataclasses.fields(got):
            tsec, jsec = getattr(got, section.name), getattr(want, section.name)
            if not dataclasses.is_dataclass(tsec):
                continue
            for field in dataclasses.fields(tsec):
                assert getattr(tsec, field.name) == getattr(jsec, field.name), (
                    argv, section.name, field.name)
    assert got.model.backbone == "wide_resnet101_2" and not got.model.remat
    with pytest.raises(ValueError) as want:
        built(jcli, ["--norm", "group", "--frozen-bn"])
    with pytest.raises(ValueError) as got:
        built(cli, ["--norm", "group", "--frozen-bn"])
    assert str(got.value) == str(want.value)


def _chrome_trace(root):
    """A capture in ``torch.profiler``'s Chrome layout: on thread 10,
    ``aten::conv2d`` encloses ``aten::cudnn_convolution``, whose
    ``cudaLaunchKernel`` (correlation 1) launches ``conv_k``; two
    ``aten::mul`` and one ``aten::add`` launch ``elem_k``; thread 11
    launches ``elem_k`` inside no operator of its own (thread 10's enclose
    its time); one ``cudaGraphLaunch`` replays ``conv_k`` and ``elem_k``; a
    memcpy is not a kernel. Times in microseconds."""
    def op(name, ts, dur, tid=10):
        return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "args": {}}

    def launch(name, ts, corr, tid=10):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": 2, "args": {"correlation": corr}}

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
                "dur": dur, "args": {"correlation": corr, "device": 0, "stream": 7}}

    events = [op("aten::conv2d", 0, 100), op("aten::cudnn_convolution", 10, 50),
              launch("cudaLaunchKernel", 20, 1), kernel("conv_k", 200, 30, 1),
              op("aten::mul", 120, 20), launch("cudaLaunchKernel", 125, 2),
              kernel("elem_k", 240, 10, 2), op("aten::mul", 150, 20),
              launch("cudaLaunchKernel", 155, 3), kernel("elem_k", 260, 12, 3),
              op("aten::add", 180, 10), launch("cudaLaunchKernel", 182, 4),
              kernel("elem_k", 280, 8, 4), launch("cudaLaunchKernel", 25, 6, tid=11),
              kernel("elem_k", 300, 5, 6), launch("cudaGraphLaunch", 400, 5),
              kernel("conv_k", 410, 40, 5), kernel("elem_k", 450, 6, 5),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
               "ts": 500, "dur": 50, "args": {"correlation": 7}},
              {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 10, "ts": 20}]
    root.mkdir()
    (root / "host_1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))


def _trace_summary_cases(cli, prof, tmp_path, capsys):
    """``trace-summary`` over ``train --profile``'s CPU capture (no device
    kernels: the ``cpu_op`` rows) and over :func:`_chrome_trace` (per-kernel
    rows, each kernel under the innermost operator enclosing its launch on
    the launch's thread, graph replays labelled and not attributed), with
    ``--top`` and ``--json`` (JAX's keys, JAX's ``format_table``); a
    directory without a capture exits 1, ``--plane`` exits 2."""
    from replication_faster_rcnn_tpu.utils import xplane as jxplane
    from replication_faster_rcnn_tpu_torch.utils import profiling

    keys = ["count", "op", "pct", "total_ms"]
    rc, out = _cli(cli.main, ["trace-summary", str(prof), "--top", "5", "--json",
                              str(tmp_path / "cpu.json")], capsys)
    table = json.loads((tmp_path / "cpu.json").read_text())
    assert rc == 0 and sorted(table) == ["operators", "ops", "trace_dir"], out
    assert table["operators"] == [] and len(table["ops"]) == 5
    assert all(sorted(r) == keys for r in table["ops"])
    assert "no device kernels" in out.out and jxplane.format_table(table["ops"]) in out.out

    _chrome_trace(tmp_path / "synthetic")
    rc, out = _cli(cli.main, ["trace-summary", str(tmp_path / "synthetic"), "--json",
                              str(tmp_path / "gpu.json")], capsys)
    table = json.loads((tmp_path / "gpu.json").read_text())
    assert rc == 0, out
    ops = {r["op"]: (r["total_ms"], r["count"], r["graph_replay"]) for r in table["ops"]}
    replay = profiling.GRAPH_REPLAY
    assert ops == {"conv_k": (0.03, 1, False), "elem_k": (0.035, 4, False),
                   f"conv_k {replay}": (0.04, 1, True), f"elem_k {replay}": (0.006, 1, True)}
    assert [r["op"] for r in table["ops"]][:2] == [f"conv_k {replay}", "elem_k"]
    operators = {r["op"]: (r["total_ms"], r["count"]) for r in table["operators"]}
    assert operators == {"aten::cudnn_convolution": (0.03, 1), "aten::mul": (0.022, 2),
                         "aten::add": (0.008, 1), profiling.NO_OPERATOR: (0.005, 1),
                         profiling.GRAPH_REPLAY_OPERATOR: (0.046, 2)}
    assert sum(r["pct"] for r in table["ops"]) == pytest.approx(100.0, abs=0.05)
    for name in ("ops", "operators"):
        assert sum(r["total_ms"] for r in table[name]) == pytest.approx(0.111)
        assert jxplane.format_table([{k: r[k] for k in keys} for r in table[name]]) in out.out
    rc, out = _cli(cli.main, ["trace-summary", str(tmp_path / "synthetic"), "--top", "2"],
                   capsys)
    assert rc == 0 and out.out.count("\n") == 9, out.out

    rc, out = _cli(cli.main, ["trace-summary", str(tmp_path / "none")], capsys)
    assert rc == 1 and "no *.pt.trace.json" in out.err
    rc, out = _cli(cli.main, ["trace-summary", str(prof), "--plane", "GPU"], capsys)
    assert rc == 2 and "--plane" in out.err and "no counterpart" in out.err


def _cli_matches_jax(tmp_path, capsys, monkeypatch, engines, paths):
    """The port's command line in-process at 96x96 on the CPU: train (bounded
    steps with telemetry, then a preempted run's emergency save), eval with the
    per-class table, quantize with the sweep (its JSON keys and groups
    against the JAX command's), predict in bfloat16 and from the int8
    sidecar (the sidecar ``serve --params-dtype int8`` loads), bench,
    telemetry (the report, and a request's timeline against the JAX
    command's), ``trace-summary`` (:func:`_trace_summary_cases`), the model
    knobs' flags (:func:`_model_knob_flags`), and the JAX flags that are not
    ported yet as argparse errors naming their ROADMAP item. Also ``eval/predict.py`` against the
    JAX module on the fixture's engines, and the ``FRCNN`` facade."""
    from replication_faster_rcnn_tpu import cli as jcli
    from replication_faster_rcnn_tpu.eval.predict import predict_images as j_predict_images
    from replication_faster_rcnn_tpu_torch import cli
    from replication_faster_rcnn_tpu_torch.eval.predict import draw_detections, predict_images
    from replication_faster_rcnn_tpu_torch.frcnn import FRCNN

    wd, tel, prof = tmp_path / "cli_wd", tmp_path / "cli_tel", tmp_path / "cli_prof"
    rc, out = _cli(cli.main, ["train", *CLI_COMMON, "--workdir", str(wd), "--steps", "2",
                              "--batch-size", "2", "--telemetry", str(tel), "--profile",
                              str(prof)], capsys)
    assert rc == 0 and "[step      0]" in out.out, out
    assert {"trace.json", "metrics.jsonl"} <= {p.name for p in tel.iterdir()}
    _trace_summary_cases(cli, prof, tmp_path, capsys)
    # a shutdown request after the first step: a verified emergency
    # checkpoint (the one the other commands load) and exit 75
    from replication_faster_rcnn_tpu_torch.train import fault

    monkeypatch.setattr(fault.GracefulShutdown, "requested", property(lambda self: True))
    rc, out = _cli(cli.main, ["train", *CLI_COMMON, "--workdir", str(wd), "--steps", "4",
                              "--batch-size", "2", "--resume"], capsys)
    monkeypatch.undo()
    assert rc == fault.EXIT_PREEMPTED == 75 and "preempted" in out.err, out
    assert sorted(p.name for p in wd.iterdir()) == ["1", "manifests"]
    rc, out = _cli(cli.main, ["eval", *CLI_COMMON, "--workdir", str(wd), "--max-images", "2",
                              "--batch-size", "2", "--per-class"], capsys)
    lines = out.out.splitlines()
    assert rc == 0 and lines[0].startswith("mAP@0.5: ") and len(lines) == 21, out
    assert lines[1].split()[:2] == ["aeroplane", "AP"]

    quant_args = ["--synthetic-calib", "--calib-batches", "1", "--calib-batch-size", "1"]
    rc, out = _cli(cli.main, ["quantize", *CLI_COMMON, "--workdir", str(wd), "--sweep",
                              *quant_args], capsys)
    got = json.loads(out.out)
    # the JAX command at 32x32 (its keys do not depend on the size; its
    # init compiles for ~25 s at 96x96)
    rc_j, out_j = _cli(jcli.main, ["quantize", *CLI_COMMON[:-1], "32", "--workdir",
                                   str(tmp_path / "none"), "--output",
                                   str(tmp_path / "jax_quant.json"), *quant_args], capsys)
    want = json.loads(out_j.out)
    assert (rc, rc_j) == (0, 0) and sorted(got) == sorted(want)
    assert got["groups"] == want["groups"] and sorted(got["plan"]) == sorted(want["plan"])
    assert got["calib"] == want["calib"] and sorted(got["sensitivity"]) == got["groups"]
    sidecar = json.loads((wd / "quant_artifact.json").read_text())
    assert got["artifact"] == str(wd / "quant_artifact.json") and sidecar["config_hash"]

    for dtype, images in (("bfloat16", paths[:1]), ("int8", paths)):
        rc, out = _cli(cli.main, ["predict", *CLI_COMMON, "--workdir", str(wd), "--image",
                                  *images, "--score-thresh", "0.0", "--params-dtype", dtype],
                       capsys)
        dets = json.loads(out.out)
        dets = [dets] if len(images) == 1 else [dets[p] for p in images]
        assert rc == 0 and all(d for d in dets), (dtype, out)
        assert all(sorted(x) == ["box", "class_id", "class_name", "score"] for d in dets
                   for x in d)

    monkeypatch.setenv("BENCH_MODE", "eval")
    monkeypatch.setenv("BENCH_STEPS", "1")
    monkeypatch.setenv("BENCH_EVAL_BATCH", "1")
    rc, out = _cli(cli.main, ["bench", *CLI_COMMON], capsys)
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and line["metric"] == "eval_images_per_sec_96x96" and line["value"] > 0

    rc, out = _cli(cli.main, ["telemetry", str(tel)], capsys)
    rc_j, out_j = _cli(jcli.main, ["telemetry", str(tel)], capsys)
    assert (rc, rc_j) == (0, 0) and "step/dispatch" in out.out
    tid = _trace_dir(tmp_path / "traces")
    for argv in (["--trace-id", tid], ["--trace-id", "cd" * 16]):
        rc, out = _cli(cli.main, ["telemetry", str(tmp_path / "traces"), *argv], capsys)
        rc_j, out_j = _cli(jcli.main, ["telemetry", str(tmp_path / "traces"), *argv], capsys)
        assert (rc, out.out) == (rc_j, out_j.out) and rc == (0 if tid in argv else 1)
    assert "network=0.08ms" in _cli(cli.main, ["telemetry", str(tmp_path / "traces"),
                                                "--trace-id", tid], capsys)[1].out

    for argv, item in ((["train", "--elastic"], "item 8"), (["train", "--strict"], "item 7"),
                       (["eval", "--mesh-shape", "2,4"], "item 8"),
                       (["train", "--pretrained-backbone", "r.pth"], "item 9"),
                       (["predict", "--image", paths[0], "--output", "o.png"], "item 9")):
        rc, out = _cli(cli.main, argv, capsys)
        assert rc == 2 and "not ported yet" in out.err and item in out.err, (argv, out.err)
    with pytest.raises(NotImplementedError, match="item 9"):
        draw_detections(paths[0], [], str(tmp_path / "o.png"))
    # --loader-mode process (the forked loader workers) reaches the config
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "cmd_train", lambda args: seen.append(cli._build_config(args)) or 0)
        for mode in ("process", "thread"):
            rc, out = _cli(cli.main, ["train", *CLI_COMMON, "--loader-mode", mode], capsys)
            assert rc == 0 and seen[-1].data.loader_mode == mode, (mode, out.err)
    _model_knob_flags(cli, jcli, capsys)

    # eval/predict.py against the JAX module on the same engines and weights
    jeng, teng, variables = engines
    cfg = _cfg(tconfig)
    want = j_predict_images(_cfg(jconfig), None, None, paths, 0.0, engine=jeng)
    got = predict_images(cfg, None, paths, 0.0, engine=teng)
    for g, w in zip(got, want):
        assert [d["class_name"] for d in g] == [d["class_name"] for d in w] and g
        np.testing.assert_allclose([d["box"] for d in g], [d["box"] for d in w], rtol=0,
                                   atol=BOX_ATOL)
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w], rtol=0,
                                   atol=SCORE_ATOL)

    # the FRCNN facade on the CPU
    with pytest.raises(ValueError, match="train or test"):
        FRCNN("serve")
    net = FRCNN("test", cfg, device="cpu")
    model, state = net.get_network()
    assert model.device.type == "cpu" and set(state) == set(model.state_dict())
    batch = next(iter(FRCNN("train", cfg.replace(data=dataclasses.replace(
        cfg.data, dataset="synthetic")), device="cpu").get_data_loader(batch_size=2)))
    assert batch["image"].shape == (2, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="item 9"):
        net.load_param("resnet18.pth")


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script_batcher(cls):
    """The batcher's hooks and accessors under one scripted sequence."""
    clock = _Clock()
    seen = []
    delays = {"a": 1.0, "b": 3.0}
    b = cls(lambda k, items: [i * 2 for i in items] if k != "bad" else 1 / 0,
            max_batch=lambda k: 3 if k == "a" else 2, max_delay_s=lambda k: delays.get(k, 2.0),
            depth=8, clock=clock, start=False,
            on_expired=lambda n: seen.append(("expired", n)),
            on_flush_result=lambda ok: seen.append(("result", ok)),
            on_flush_stats=lambda k, w: seen.append(("stats", k, [round(x, 9) for x in w])))
    futs = [b.submit("a", 1), b.submit("b", 2, deadline_s=0.5), b.submit("a", 3)]
    clock.t += 0.25
    futs += [b.submit("bad", 4), b.submit("a", 5), b.submit("bad", 6)]
    depths = [dict(b.key_depths()), b.queue_depth(), b.delay_s("a"), b.delay_s("b")]
    for _ in range(6):
        b._service_once(block=False)
    clock.t += 4.0
    b._service_once(block=False)
    b.close()
    outcome = []
    for f in futs:
        e = f.exception()
        outcome.append(type(e).__name__ if e is not None else f.result())
    return seen, depths, b.flush_log, b.expired_total, outcome


def _script_pure(mods):
    """metrics, slo_burn, tracecontext, overload, slo and failpoints under
    one scripted sequence; returns every output."""
    m, burn, tc, ov, slo, fp = mods
    out = {}
    reg = m.MetricsRegistry()
    reg.counter("serve_requests_total", help="r").inc(3)
    reg.counter("serve_shed_total", help="s", bucket="32x32").inc()
    reg.gauge("serve_queue_depth", help="q").set(4)
    hist = reg.histogram("serve_flush_seconds", help="f", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.02, 0.05, 0.5, 2.0):
        hist.observe(v)
    reg.register_collector(lambda: reg.gauge("serve_uptime_seconds", help="u").set(7.5))
    out["metrics"] = (reg.snapshot(), reg.render_prometheus(), reg.counters_flat(),
                      [hist.percentile(q) for q in (50, 95, 99)],
                      m.stats_payload("replica", reg, stats={"a": 1}),
                      m.PROMETHEUS_CONTENT_TYPE, m.DEFAULT_LATENCY_BUCKETS_S)
    clock = _Clock()
    tracker = burn.BurnRateTracker(availability_target=0.99, latency_target_s=0.1,
                                   short_window_s=60.0, long_window_s=600.0, clock=clock)
    snaps = []
    for i in range(300):
        clock.t += 1.5
        tracker.record(i % 7 != 0, latency_s=0.05 * (i % 5))
        if i % 50 == 0:
            snaps.append((tracker.snapshot(), tracker.burn_rates(), tracker.alarm()))
    out["slo_burn"] = snaps
    parent = tc.parse_traceparent("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    child = parent.child()
    out["tracecontext"] = (
        parent.to_traceparent(), parent.span_args(),
        [tc.parse_traceparent(h) is None for h in
         (None, "", "00-xyz", "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
          "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01")],
        child.trace_id == parent.trace_id, child.parent_span_id == parent.span_id,
        len(child.span_id), tc.TRACEPARENT_HEADER)
    with tc.bind(parent):
        inner = tc.current_trace().to_traceparent()
    out["tracecontext"] += (inner, tc.current_trace())
    out["overload"] = ([ov.retry_after_s(ms) for ms in (0, 10, 999, 1000, 2500.5)],
                       list(ov.backoff_delays(seed=3)), list(ov.backoff_delays(0.01, 0.05, 5, 9)))
    ctl = slo(slo_ms=50.0, floor_ms=1.0, ceiling_ms=40.0, step=1.5,
                                 initial_ms=10.0, max_batch=lambda k: 4, window=4)
    history = []
    for i in range(40):
        key = ("b", i % 2)
        waits = [0.001 * ((i * 7) % 60) for _ in range(1 + i % 3)]
        ctl.on_flush(key, waits)
        history.append((ctl.delay_s(key), ctl.adaptations))
    out["slo"] = (history, ctl.delays_ms())
    events = []
    rules = fp.configure("batcher.flush:ioerror:0.5:7,http.handler:drop:1.0:1:0:2:3",
                         sink=events.append)
    fired = []
    for i in range(12):
        for site in ("batcher.flush", "http.handler"):
            try:
                fault = fp.fire(site, i=i)
                fired.append(None if fault is None else (fault.kind, fault.seq))
            except fp.ChaosError as e:
                fired.append(("raised", str(e)))
    out["failpoints"] = ([dataclasses.asdict(r) for r in rules], fired, fp.event_log(),
                         fp.site_hits(), events, fp.KINDS)
    fp.disarm()
    return out


class _StubEngine:
    """submit() answers at once; sheds the first ``shed`` admission tries."""

    def __init__(self, shed=0):
        self.shed, self.calls = shed, 0
        self.lock = threading.Lock()

    def submit(self, image, timeout=None):
        with self.lock:
            self.calls += 1
            if timeout == 0 and self.calls <= self.shed:
                raise queue.Full
        fut = Future()
        if int(image[0, 0, 0]) == 255:
            fut.set_exception(ValueError("bad image"))
        else:
            fut.set_result({"n": 1})
        return fut


def _script_loadgen(lg):
    images = [np.zeros((4, 4, 3), np.uint8), np.full((4, 4, 3), 255, np.uint8)]
    runs = [lg.run_closed_loop(_StubEngine(), images, 10),
            lg.run_closed_loop(_StubEngine(shed=3), images, 6, admission=True, seed=2),
            lg.run_open_loop(_StubEngine(), images, 500.0, n_requests=8),
            lg.run_open_loop(_StubEngine(), images, 400.0, duration_s=0.02)]
    timed = ("wall_s", "images_per_sec", "p50_ms", "p99_ms", "mean_ms")
    return [{k: v for k, v in r.items() if k not in timed} for r in runs], \
        [sorted(r) for r in runs], lg.percentile_ms([0.001, 0.002, 0.010], 50)


def test_host_modules_and_loadgen_match_jax():
    """The pure host modules and the batcher's hooks on scripted events and
    an injected clock, and the load generator over a stub engine: equal
    outputs on both sides. The port's closed loop with ``concurrency`` (K
    clients) answers every request with the same counts."""
    assert _script_batcher(MicroBatcher) == _script_batcher(JMicroBatcher)
    got = _script_pure((metrics, slo_burn, tracecontext, overload, DeadlineController,
                        failpoints))
    want = _script_pure((j_metrics, j_slo_burn, j_tracecontext, j_overload,
                         JDeadlineController, j_failpoints))
    assert got == want
    # the port registers the sites it fires, each one of JAX's, and rejects
    # the others until the code that fires them is ported
    assert set(failpoints.SITES) == {"loader.fetch", "batcher.flush", "http.handler"}
    assert set(failpoints.SITES) <= set(j_failpoints.SITES)
    # the nan fault's poison, as JAX's: a float image all NaN, a uint8 one untouched
    for image in (np.ones((2, 3, 3), np.float32), np.ones((2, 3, 3), np.uint8)):
        sample = {"image": image, "labels": np.arange(3)}
        got_p, want_p = failpoints.poison_batch(sample), j_failpoints.poison_batch(sample)
        assert got_p.keys() == want_p.keys() and sample["image"] is image
        for k in want_p:
            np.testing.assert_array_equal(got_p[k], want_p[k])
    with pytest.raises(ValueError, match="unknown failpoint site"):
        failpoints.configure("checkpoint.write:ioerror:1.0:0")
    assert not failpoints.armed()
    assert _script_loadgen(loadgen) == _script_loadgen(j_loadgen)
    images = [np.zeros((4, 4, 3), np.uint8)]
    k4 = loadgen.run_closed_loop(_StubEngine(), images, 12, concurrency=4)
    plain = loadgen.run_closed_loop(_StubEngine(), images, 12)
    assert k4.pop("concurrency") == 4
    assert {k: v for k, v in k4.items() if k in ("n_requests", "errors", "shed", "timeouts")} \
        == {k: v for k, v in plain.items() if k in ("n_requests", "errors", "shed", "timeouts")}
    with pytest.raises(ValueError):
        loadgen.run_closed_loop(_StubEngine(), images, 2, concurrency=0)
