"""Quantization sidecar artifact: CRC-manifested JSON next to the checkpoint
(a copy of the JAX package's ``quant/artifact.py``, so that either package
loads the other's sidecar byte for byte).

Every scale tensor is recorded with its crc32/shape/dtype, the file carries
a schema tag, and the write is atomic (tmp + ``os.replace``), so a crash
mid-write never leaves a half-artifact that int8 serving would trust.

The payload is pure JSON with scale bytes base64-encoded from their float32
little-endian buffer: byte-exact round trips, and, because calibration is
order-invariant (``calibrate.py``), the file is bit-identical across runs
for the same weights and calibration batches (``sort_keys`` + fixed
separators).
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import zlib
from typing import Any, Dict, Optional

import numpy as np

ARTIFACT_SCHEMA = "quant_artifact/v1"
ARTIFACT_BASENAME = "quant_artifact.json"


class QuantArtifactError(RuntimeError):
    """Missing, corrupt, or schema-incompatible quantization sidecar."""


def default_artifact_path(config, checkpoint_dir: Optional[str] = None) -> str:
    """``quant.artifact`` if set, else ``<checkpoint_dir>/quant_artifact.json``."""
    quant_cfg = getattr(config, "quant", None)
    configured = getattr(quant_cfg, "artifact", "") if quant_cfg else ""
    if configured:
        return configured
    base = checkpoint_dir or getattr(
        getattr(config, "train", None), "checkpoint_dir", ""
    ) or "."
    return os.path.join(base, ARTIFACT_BASENAME)


def _encode_scale(arr: np.ndarray) -> Dict[str, Any]:
    arr = np.ascontiguousarray(np.asarray(arr, dtype="<f4"))
    raw = arr.tobytes()
    return {
        "b64": base64.b64encode(raw).decode("ascii"),
        "shape": list(arr.shape),
        "dtype": "float32",
        "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
    }


def _decode_scale(path: str, rec: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(rec["b64"])
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    if crc != rec["crc32"]:
        raise QuantArtifactError(
            f"quant artifact CRC mismatch for scale {path!r}: "
            f"recorded {rec['crc32']}, computed {crc}"
        )
    return np.frombuffer(raw, dtype="<f4").reshape(rec["shape"]).copy()


def save_artifact(
    path: str, artifact: Dict[str, Any], config_hash: Optional[str] = None
) -> str:
    """Serialize a `calibrate.py`/`sensitivity.py` artifact dict atomically."""
    doc = {
        "schema": ARTIFACT_SCHEMA,
        "config_hash": config_hash,
        "calib": artifact.get("calib", {}),
        "activation_ranges": {
            k: float(v) for k, v in sorted(artifact["activation_ranges"].items())
        },
        "groups": {g: list(ps) for g, ps in sorted(artifact["groups"].items())},
        "plan": {g: artifact["plan"][g] for g in sorted(artifact["plan"])},
        "sensitivity": artifact.get("sensitivity", {}),
        "weight_scales": {
            k: _encode_scale(v)
            for k, v in sorted(artifact["weight_scales"].items())
        },
    }
    payload = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=".quant_artifact."
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_artifact(path: str) -> Dict[str, Any]:
    """Load + CRC-verify a sidecar; raises :class:`QuantArtifactError`."""
    if not os.path.exists(path):
        raise QuantArtifactError(
            f"no quantization sidecar at {path!r} — run `frcnn quantize` "
            "against this checkpoint first (it writes the calibration "
            "artifact serving.params_dtype=int8 requires; in this package: "
            "quant.calibrate, quant.sweep and quant.save_artifact)"
        )
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise QuantArtifactError(f"unreadable quant artifact {path!r}: {e}")
    if doc.get("schema") != ARTIFACT_SCHEMA:
        raise QuantArtifactError(
            f"quant artifact {path!r} has schema {doc.get('schema')!r}, "
            f"expected {ARTIFACT_SCHEMA!r} — re-run `frcnn quantize`"
        )
    scales = {
        k: _decode_scale(k, rec) for k, rec in doc["weight_scales"].items()
    }
    return {
        "schema": doc["schema"],
        "config_hash": doc.get("config_hash"),
        "calib": doc.get("calib", {}),
        "activation_ranges": dict(doc["activation_ranges"]),
        "groups": {g: list(ps) for g, ps in doc["groups"].items()},
        "plan": dict(doc["plan"]),
        "sensitivity": doc.get("sensitivity", {}),
        "weight_scales": scales,
    }
