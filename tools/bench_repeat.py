"""Repeat the port's benchmark as users run it and print the spread of its
lines, per arm, mode and timed window.

    python tools/bench_repeat.py [--runs 5] [--steps 10 100] [--modes train eval]
                                 [--arms DIR[:KEY=VALUE,...] ...]

Each run is ``python -m replication_faster_rcnn_tpu_torch.benchmark`` in a
fresh process with ``BENCH_MODE`` and ``BENCH_STEPS`` set and every other
``BENCH_*`` variable cleared. An arm is a tree to run it from (default: this
repository) with optional ``BENCH_*`` settings of its own, e.g. ``--arms
build/parent . .:BENCH_CAPTURE=0`` compares an unpacked parent commit, this
tree, and this tree's eager step. A round runs every (window, mode, arm)
once, the arms in turn and in reverse order every other round (A B, B A,
...), so the card's and the host's drift spread over all of them. Prints the
card line, every benchmark line, then one JSON object per (arm, window,
mode): median, min, max and the largest deviation from the median in
percent, and, with several arms, each arm's median against the first's.
Needs a CUDA card; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def parse_arm(spec: str):
    """``DIR[:KEY=VALUE,...]`` -> (label, directory, extra environment)."""
    where, _, settings = spec.partition(":")
    env = dict(kv.split("=", 1) for kv in settings.split(",") if kv)
    return spec, (REPO / where).resolve(), env


def run_once(mode: str, steps: int, tree: Path = REPO, extra=None) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODE=mode, BENCH_STEPS=str(steps), **(extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "replication_faster_rcnn_tpu_torch.benchmark"],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{mode} run at BENCH_STEPS={steps} in {tree} exited "
                         f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def spread(values):
    med = statistics.median(values)
    return {"median": med, "min": min(values), "max": max(values),
            "max_dev_pct": round(100 * max(abs(v - med) for v in values) / med, 2),
            "values": values}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, nargs="+", default=[10, 100])
    ap.add_argument("--modes", nargs="+", default=["train", "eval"])
    ap.add_argument("--arms", nargs="+", default=["."])
    args = ap.parse_args()
    arms = [parse_arm(a) for a in args.arms]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    values = {(a[0], s, m): [] for a in arms for s in args.steps for m in args.modes}
    for i in range(args.runs):
        for steps in args.steps:
            for mode in args.modes:
                for label, tree, extra in (arms if i % 2 == 0 else arms[::-1]):
                    t0 = time.perf_counter()
                    line = run_once(mode, steps, tree, extra)
                    values[(label, steps, mode)].append(line["value"])
                    print(f"round {i + 1} {label} BENCH_STEPS={steps} {mode} "
                          f"({time.perf_counter() - t0:.1f} s): {json.dumps(line)}", flush=True)
    for (label, steps, mode), vals in values.items():
        out = {"arm": label, "mode": mode, "bench_steps": steps, **spread(vals)}
        base = values[(arms[0][0], steps, mode)]
        if len(arms) > 1:
            out["median_vs_first_arm_pct"] = round(
                100 * (statistics.median(vals) / statistics.median(base) - 1), 2)
        print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
