"""Drive the dry-run sweep on the PyTorch port: every (arch x shape x
mesh) pair (counterpart of the reference's ``benchmarks/run_dryruns.py``).

Each pair runs ``python -m repro_torch.launch.dryrun`` in a fresh
subprocess (one fake process group a process). Records are cached as
JSON under ``experiments/dryrun_torch/`` -- re-runs skip completed pairs
unless ``--force``; the reference's ``experiments/dryrun/`` is not
touched. Train pairs run the two-axis round, ``--fl-engine sharded_fused
--fl-shard-model``, at Q = 2 by default, the Q of the reference's
committed two-axis records; every arch (``TREE_ARCHS``) also runs the
reference's default, ``--fl-engine tree``, on the ``(node, model)``
layout with tensor-parallel layers (ROADMAP.md queue 1, item 18b slices
(i)-(iii); the reference's file name, no engine suffix); ``--engine flat
fused`` runs those two, a node's model ranks as replicas. Serving pairs
run rank 0's own call on its tensor-parallel shards. Exit code is
nonzero if any pair fails.

  PYTHONPATH=src python -m repro_torch.benchmarks.run_dryruns
      [--mesh single|multi|both] [--arch ARCH ...] [--shape SHAPE ...]
      [--engine ENGINE ...] [--q 2] [--jobs N] [--force]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.path.join(REPO, "experiments", "dryrun_torch")

ARCHS = [
    "phi3-medium-14b",
    "recurrentgemma-2b",
    "internvl2-26b",
    "smollm-360m",
    "rwkv6-7b",
    "qwen2.5-32b",
    "dbrx-132b",
    "whisper-medium",
    "llama4-scout-17b-a16e",
    "tinyllama-1.1b",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the flags of a train pair's engine: the two-axis round, the
#: tensor-parallel ``tree`` round, and ``flat`` / ``fused`` with a node's
#: model ranks as replicas (reachable by name -- ``--engine`` -- but not in
#: the default sweep: the reference's sweep runs neither)
TRAIN_FLAGS = {"sharded_fused": ["--fl-engine", "sharded_fused", "--fl-shard-model"],
               "tree": ["--fl-engine", "tree"],
               "flat": ["--fl-engine", "flat"],
               "fused": ["--fl-engine", "fused"]}
#: the engines a train pair runs by default
DEFAULT_ENGINES = ("sharded_fused", "tree")
#: the archs whose train pair also runs ``tree`` (tensor-parallel layers,
#: expert-parallel MoE): every one
TREE_ARCHS = ["smollm-360m", "tinyllama-1.1b", "phi3-medium-14b", "qwen2.5-32b",
              "dbrx-132b", "llama4-scout-17b-a16e", "internvl2-26b", "rwkv6-7b",
              "recurrentgemma-2b", "whisper-medium"]


def pair_argv(arch: str, shape: str, mesh: str, q: int,
              engine: str = "sharded_fused") -> List[str]:
    argv = ["--arch", arch, "--shape", shape, "--mesh", mesh, "--q", str(q)]
    return argv + (TRAIN_FLAGS[engine] if shape == "train_4k" else [])


def record_path(arch: str, shape: str, mesh: str, q: int = 2,
                engine: str = "sharded_fused") -> str:
    args = dryrun._parser().parse_args(pair_argv(arch, shape, mesh, q, engine))
    return os.path.join(OUT_DIR, dryrun.record_name(args))


def run_one(arch: str, shape: str, mesh: str, q: int, engine: str = "sharded_fused",
            timeout: int = 3600) -> Dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           *pair_argv(arch, shape, mesh, q, engine), "--out", OUT_DIR]
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    dt = time.time() - t0
    path = record_path(arch, shape, mesh, q, engine)
    if proc.returncode != 0 or not os.path.exists(path):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "stderr_tail": proc.stderr[-3000:] or "no record written",
                "wall_s": round(dt, 1)}
    with open(path) as f:
        rec = json.load(f)
    rec["wall_s"] = round(dt, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    ap.add_argument("--shape", nargs="*", default=SHAPE_NAMES)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--engine", nargs="*", default=list(DEFAULT_ENGINES),
                    choices=sorted(TRAIN_FLAGS),
                    help="the train pairs' engines (tree for TREE_ARCHS only)")
    ap.add_argument("--jobs", type=int, default=1, help="pairs run at once")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(OUT_DIR, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo, total = [], 0
    for mesh in meshes:
        for arch in args.arch:
            for shape in args.shape:
                engines = ["sharded_fused"] if shape != "train_4k" else [
                    e for e in args.engine if e != "tree" or arch in TREE_ARCHS]
                for engine in engines:
                    total += 1
                    path = record_path(arch, shape, mesh, args.q, engine)
                    if os.path.exists(path) and not args.force:
                        with open(path) as f:
                            rec = json.load(f)
                        if rec["status"] != "error":  # errors are always retried
                            print(f"[cached] {arch} x {shape} x {mesh}: {rec['status']}")
                            continue
                    todo.append((arch, shape, mesh, engine))
    failures = []
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = {pool.submit(run_one, arch, shape, mesh, args.q, engine):
                   (arch, shape, mesh, engine) for arch, shape, mesh, engine in todo}
        for fut in concurrent.futures.as_completed(futures):
            arch, shape, mesh, engine = futures[fut]
            rec = fut.result()
            status, extra = rec["status"], ""
            if status == "ok":
                extra = (f" flops/rank={rec['flops']:.3e}"
                         f" coll={rec['collectives']['total_bytes']:.3e}B"
                         f" trace={rec.get('trace_s', 0)}s")
            elif status == "error":
                with open(record_path(arch, shape, mesh, args.q, engine), "w") as f:
                    json.dump(rec, f, indent=2)
                failures.append((arch, shape, mesh, engine))
                extra = " :: " + rec.get("stderr_tail", "")[-400:].replace("\n", " | ")
            print(f"[{status}] {arch} x {shape} x {mesh} {engine if shape == 'train_4k' else ''}"
                  f" ({rec.get('wall_s', '?')}s){extra}")
            sys.stdout.flush()
    print(f"\n{total - len(failures)}/{total} pairs OK")
    if failures:
        print("FAILURES:")
        for f3 in sorted(failures):
            print("  ", f3)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
