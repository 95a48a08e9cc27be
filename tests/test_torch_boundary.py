"""The PyTorch port's package boundary: it imports no JAX and nothing of the
JAX package (only tests import both), and its entry points run on the card
unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "replication_faster_rcnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "replication_faster_rcnn_tpu")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value), node.lineno


def _forbidden(module):
    root = module.split(".")[0]
    return root in FORBIDDEN and root != "replication_faster_rcnn_tpu_torch"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(m, line) for m, line in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_catches_forbidden_imports():
    src = "import jax\nfrom replication_faster_rcnn_tpu.ops import nms\nimport flax.linen\n" \
          "from replication_faster_rcnn_tpu_torch import ops\n"
    found = [m for m, _ in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax", "replication_faster_rcnn_tpu.ops", "flax.linen"]


def _entry_points():
    from replication_faster_rcnn_tpu_torch import config, resolve_device
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator
    from replication_faster_rcnn_tpu_torch.serving.engine import (
        InferenceEngine,
        get_engine,
        get_evaluator,
    )
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = config.get_config("voc12_resnet18_align")
    return {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "FasterRCNN": lambda **kw: FasterRCNN(cfg, **kw),
        "build_model": lambda **kw: build_model(cfg, **kw),
        "build_model FPN": lambda **kw: build_model(config.get_config("voc_resnet50_fpn"), **kw),
        "InferenceEngine": lambda **kw: InferenceEngine(cfg, **kw),
        "Trainer": lambda **kw: Trainer(cfg, SyntheticDataset(cfg.data, length=8), **kw),
        "Evaluator": lambda **kw: Evaluator(cfg, **kw),
        "get_engine": lambda **kw: get_engine(cfg, **kw),
        "get_evaluator": lambda **kw: get_evaluator(cfg, **kw),
    }


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """With no device argument every entry point targets cuda: without a GPU
    it raises; with device="cpu" it runs on the CPU. One test id walks all
    of them (each test id costs the fast tier's budget). The ``serve``
    subcommand (``--device auto``, its default, or ``cuda``) raises before
    it listens."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from replication_faster_rcnn_tpu_torch.cli import main

    for device in ((), ("--device", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "--config", "voc12_resnet18_align", "--workdir",
                  str(tmp_path), "--port", "0", *device])
    entry_points = _entry_points()
    assert list(entry_points) == ["resolve_device", "FasterRCNN", "build_model",
                                  "build_model FPN", "InferenceEngine", "Trainer", "Evaluator", "get_engine",
                                  "get_evaluator"]
    for name, make in entry_points.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda")
        obj = make(device="cpu")
        dev = obj if isinstance(obj, torch.device) else obj.device
        assert dev.type == "cpu", name
        if hasattr(obj, "close"):
            obj.close()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when CUDA is
    unavailable — also when copied alone into an empty directory."""
    import subprocess
    import sys

    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
            timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
