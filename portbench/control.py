#!/usr/bin/env python3
"""Readings for the limits of a cell's check, on the card, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 3 --seconds 5

For each seed: the cell's set-up and a short window at the cell's own
sizes and load, then the check: the program's readings (the lower ones),
and on the first --control-seeds seeds the control's, the reference with each
model in the next lower precision than the configuration states for it
(fp8 for bf16, TF32 for float32). One JSON line per seed on standard output. The
benchmark's own runs never run the control. Like a run, it prints
nothing once a module of JAX or of the JAX package has loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    benchmark = bench.load_json(bench.REPO, "BENCHMARK.json")
    cell = bench.cell_of(benchmark, args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = bench.run_cell(cell, seed, args.seconds, False, device, control=i < args.control_seeds)
        if rec["forbidden"]:  # read after the check's imports
            print(f"modules of JAX or the JAX package loaded: {rec['forbidden']}", file=sys.stderr)
            return 3
        line = {"seed": seed, "setup_s": rec["setup_s"], "attempted": rec["attempted"],
                "failed": rec["failed"], "end_to_end": rec["end_to_end"], **rec["checks"]}
        print(json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
