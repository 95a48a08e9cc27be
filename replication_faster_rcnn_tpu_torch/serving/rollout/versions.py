"""Version discovery + eligibility over the trainer's manifest feed (a copy
of the JAX package's ``serving/rollout/versions.py``, over the port's
checkpoint store: ``<workdir>/<step>/state.pt``).

A *version* is a checkpoint step whose sidecar manifest
(train/fault.py, ``ckpt_manifest/v1``) is readable and internally
consistent. Discovery prefers the append-only ``manifests/feed.jsonl``
publication log (publication order survives pruning) and falls back to
scanning ``manifests/*.json``.

Eligibility is the rollout controller's pre-drain gate: everything that
can be checked WITHOUT touching a replica is checked here, because a
validation failure discovered mid-rollout would strand a drained
replica. In particular, an int8 fleet re-reads the quant sidecar
artifact (CRC per scale record) at validation time — a missing or
corrupt sidecar makes the version ineligible before any drain, instead
of blowing up inside ``swap_params`` on a replica that already left
rotation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.train import fault

__all__ = ["Eligibility", "VersionFeed"]


@dataclasses.dataclass
class Eligibility:
    """One version's pre-drain verdict. ``reasons`` is empty iff
    ``eligible`` — every entry is one human-readable disqualifier."""

    step: int
    eligible: bool
    reasons: List[str]
    manifest: Optional[Dict[str, Any]] = None

    @property
    def version(self) -> str:
        return str(self.step)


class VersionFeed:
    """Discover and validate checkpoint versions under one workdir.

    ``config`` (a FasterRCNNConfig) enables the config-hash and quant-
    sidecar checks; without it only manifest integrity + topology are
    judged. ``artifact_path`` overrides where the int8 sidecar is
    expected (default: the ``serve`` subcommand's resolution —
    ``quant.artifact`` if set, else ``<workdir>/quant_artifact.json``).
    """

    def __init__(
        self,
        workdir: str,
        config: Any = None,
        artifact_path: Optional[str] = None,
    ) -> None:
        self.workdir = os.path.abspath(workdir)
        self.config = config
        self.artifact_path = artifact_path

    # ------------------------------------------------------------ discovery

    def _manifest_dir(self) -> str:
        return os.path.join(self.workdir, fault.MANIFEST_DIRNAME)

    def poll(self) -> List[int]:
        """Published steps in publication order (feed.jsonl), with any
        manifests the feed missed (pre-feed checkpoints, torn appends)
        merged in ascending-step order after."""
        seen: List[int] = []
        try:
            with open(fault.feed_path(self.workdir)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        event = json.loads(line)
                        step = int(event["step"])
                    except (ValueError, KeyError, json.JSONDecodeError):
                        continue  # a torn append is not a version
                    if step not in seen:
                        seen.append(step)
        except OSError:
            pass
        try:
            names = os.listdir(self._manifest_dir())
        except OSError:
            names = []
        scanned = sorted(
            int(n[: -len(".json")])
            for n in names
            if n.endswith(".json") and n[: -len(".json")].isdigit()
        )
        for step in scanned:
            if step not in seen:
                seen.append(step)
        return seen

    # ----------------------------------------------------------- eligibility

    def validate(self, step: int) -> Eligibility:
        """The pre-drain gate for one version; every check that can run
        without touching a replica runs here."""
        step = int(step)
        reasons: List[str] = []
        manifest = fault.load_manifest(self.workdir, step)
        if manifest is None:
            return Eligibility(
                step,
                False,
                [
                    "manifest missing, unreadable, or wrong schema "
                    f"(want {fault.MANIFEST_SCHEMA})"
                ],
            )
        if int(manifest.get("step", -1)) != step:
            reasons.append(
                f"manifest step {manifest.get('step')} != filename step "
                f"{step}"
            )
        leaves = manifest.get("leaves") or {}
        if not leaves:
            reasons.append("manifest has no leaf records")
        elif manifest.get("leaf_count") != len(leaves):
            reasons.append(
                f"leaf_count {manifest.get('leaf_count')} != "
                f"{len(leaves)} leaf records (torn manifest?)"
            )
        for key, rec in leaves.items():
            if not isinstance(rec, dict) or "crc32" not in rec:
                reasons.append(f"leaf {key} has no crc32 record")
                break
        topo = manifest.get("topology")
        if not isinstance(topo, dict) or not topo.get("device_count"):
            reasons.append("manifest has no saving-run topology")
        if failpoints.find_step_dir(
            self.workdir, step, exclude=(fault.MANIFEST_DIRNAME,)
        ) is None:
            reasons.append(
                f"no checkpoint step directory for step {step} "
                "(pruned after publication?)"
            )
        if self.config is not None:
            reasons.extend(self._config_checks(manifest))
        return Eligibility(
            step, not reasons, reasons, manifest=manifest
        )

    def _config_checks(self, manifest: Dict[str, Any]) -> List[str]:
        reasons: List[str] = []
        cfg = self.config
        if getattr(cfg.rollout, "require_config_hash", True):
            want = fault.config_hash(cfg)
            got = manifest.get("config_hash")
            if got is not None and got != want:
                reasons.append(
                    f"config hash {got} != serving config {want} "
                    "(set rollout.require_config_hash=false to allow)"
                )
        if getattr(cfg.serving, "params_dtype", None) == "int8":
            from replication_faster_rcnn_tpu_torch.quant import (
                QuantArtifactError,
                default_artifact_path,
                load_artifact,
            )

            path = self.artifact_path or default_artifact_path(
                cfg, self.workdir
            )
            try:
                load_artifact(path)  # CRC-verifies every scale record
            except QuantArtifactError as e:
                reasons.append(f"int8 quant sidecar rejected: {e}")
        return reasons

    def latest_eligible(
        self, after: Optional[int] = None
    ) -> Optional[Eligibility]:
        """The newest published version that passes :meth:`validate`
        (restricted to steps > ``after`` when given), or ``None``."""
        steps = [
            s
            for s in self.poll()
            if after is None or int(s) > int(after)
        ]
        for step in sorted(steps, reverse=True):
            verdict = self.validate(step)
            if verdict.eligible:
                return verdict
        return None
