"""Time K5 (the port's cosine top-k kernel) of two checkouts on one CUDA card, in turns.

    python3 scripts/torch_topk_ab.py DIR_A DIR_B

DIR_A and DIR_B are roots of two checkouts of the repository (for example
the parent commit unpacked with `git archive` beside the working tree).
Each turn is a fresh process that imports `hippomm_tpu_torch` from one of
them, builds its kernels and times `top_k_cosine_kernel` at the search
path's shapes, stores of (200000, 1024) at k 20 and (1000000, 1024) at
k 128, with the same seeded data: ms per call (CUDA events, the median of
5 means of 20 calls after a warmup), in the order A, B, B, A. It prints
one line a turn and, last, the card's name and power limit and a JSON
object with every turn's numbers.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPES = [(200_000, 1024, 20), (1_000_000, 1024, 128)]


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from hippomm_tpu_torch.ops import topk as ttk

    package = os.path.dirname(os.path.dirname(os.path.abspath(ttk.__file__)))
    assert os.path.dirname(package) == os.path.abspath(root), (package, root)
    dev = torch.device("cuda")
    out = {}
    for n, d, k in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        feats = torch.randn((n, d), generator=gen, device=dev)
        feats /= feats.norm(dim=1, keepdim=True)
        q = torch.randn((d,), generator=gen, device=dev)
        for _ in range(3):
            ttk.top_k_cosine_kernel(q, feats, k)
        means = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                ttk.top_k_cosine_kernel(q, feats, k)
            end.record()
            torch.cuda.synchronize()
            means.append(start.elapsed_time(end) / 20)
        out[f"{n}x{d} k{k}"] = statistics.median(means)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for label, root in (("A", argv[0]), ("B", argv[1]), ("B", argv[1]), ("A", argv[0])):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return 1
        ms = json.loads(run.stdout.strip().splitlines()[-1])
        turns.append({"checkout": label, "root": root, "ms": ms})
        print(f"{label} {root}: {ms}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "card unknown", flush=True)
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
