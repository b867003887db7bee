"""Time variants of the port's K5 source (csrc/topk_cosine.cu) and plan on one CUDA card.

    python3 scripts/torch_topk_variants.py NAME=SUBS [NAME=SUBS ...]

As scripts/torch_flash_variants.py, for the cosine top-k: each NAME=SUBS
builds a copy of hippomm_tpu_torch/csrc/topk_cosine.cu with the text
substitutions SUBS applied (``old|||new`` pairs joined by ``;;``; an empty
SUBS is the source as it is). NAME may carry plan settings in brackets,
``name[chunk_kb=64,ring_kb=128,per_sm=1]``: the bytes of a ring slot and of
the ring, and the blocks an SM takes (ops/topk._topk_plan's _CHUNK_BYTES,
_RING_BYTES, _MAX_BLOCKS_PER_SM). Each variant then runs K5 at the path's
shapes — stores of (200000, 1024) at k 20 and 40, (1000000, 1024) at k 128,
and an ascending-sorted (200000, 1024) store at k 20, where every row
passes the filter — in turn, twice: whether it agrees with the plain
version (chip_smoke.topk_mismatch), ms per call (chip_smoke.cuda_ms), device
µs per kernel (chip_smoke.device_us) and its share of the HBM bound; once per
shape ``torch.topk(feats @ qn, k)``'s ms. For example, the ring depth, the
chunk rows, the flush schedule and what the last block's merge costs
(`nomerge` writes no result: read its time only; its check may pass on a
stale output buffer):

    python3 scripts/torch_topk_variants.py 'base=' 'deep[ring_kb=192,per_sm=1]=' 'rows16[chunk_kb=64]=' \\
        'late=    int next_flush = min(max(1, (2 * k + rows_per_chunk - 1) / rows_per_chunk), flush_every);|||    int next_flush = flush_every;' \\
        'nomerge=  if (!sh.last) return;|||  if (!sh.last) return; if (tid == 0) *ticket = 0u; if (k > 0) return;'
"""

from __future__ import annotations

import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("hmm_topk_cosine_f32",)
SHAPES = [(200_000, 1024, 20, False), (200_000, 1024, 40, False), (1_000_000, 1024, 128, False),
          (200_000, 1024, 20, True)]
PLAN_KEYS = {"chunk_kb": ("_CHUNK_BYTES", 1024), "ring_kb": ("_RING_BYTES", 1024),
             "per_sm": ("_MAX_BLOCKS_PER_SM", 1)}


def store(n, d, ascending, gen):
    """Unit rows (as the search route uploads them) and a query; with
    `ascending`, the rows sorted by their similarity to it, lowest first."""
    import torch

    feats = torch.randn((n, d), generator=gen, device="cuda")
    feats /= feats.norm(dim=1, keepdim=True)
    q = torch.randn((d,), generator=gen, device="cuda")
    if ascending:
        feats = feats[torch.argsort(feats @ (q / q.norm()))].contiguous()
    return q, feats


def main(argv) -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from hippomm_tpu_torch.ops import _native
    from hippomm_tpu_torch.ops import topk as ttk

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from torch_fused_mlp_variants import build

    plans, subs = {}, {}
    for arg in argv:
        m = re.fullmatch(r"(\w+)(?:\[([^\]]*)\])?=(.*)", arg, re.S)
        if m is None:
            sys.exit(f"not NAME=SUBS or NAME[settings]=SUBS: {arg!r}")
        name, settings, subs[name] = m.groups()
        plans[name] = {}
        for kv in filter(None, (settings or "").split(",")):
            key, value = kv.split("=")
            attr, unit = PLAN_KEYS[key]
            plans[name][attr] = int(value) * unit
    libs = build(subs, "topk_cosine.cu", ENTRIES)
    real = _native.kernels()
    defaults = {attr: getattr(ttk, attr) for attr, _ in PLAN_KEYS.values()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for n, d, k, ascending in SHAPES:
            q, feats = store(n, d, ascending, gen)
            what = f"K5 {(n, d, k)}{' ascending' if ascending else ''}"
            qn = q / q.norm()
            lib_ms = cs.cuda_ms(lambda: torch.topk(feats @ qn, k), iters=20, repeats=5)
            b_ms, _ = cs.bound(4 * n * d + 4 * d + 8 * k, 4 * n * d, cs.PEAK_FP32_FLOP_S)
            rvals, ridx = ttk.top_k_cosine_ref(q, feats, k)
            print(f"{what}: library {lib_ms:.4f} ms, bound {b_ms:.4f} ms", flush=True)
            for _ in range(2):
                for name, lib in libs.items():
                    _native._kernels = lib
                    for attr, value in {**defaults, **plans[name]}.items():
                        setattr(ttk, attr, value)
                    ttk._topk_plan.cache_clear()
                    plan = ttk._topk_plan(n, d, k, torch.cuda.get_device_properties(0).multi_processor_count)
                    vals, idx = ttk.top_k_cosine_kernel(q, feats, k)
                    bad = cs.topk_mismatch(vals, idx, rvals, ridx)
                    call = lambda: ttk.top_k_cosine_kernel(q, feats, k)  # noqa: E731
                    ms = cs.cuda_ms(call, iters=20, repeats=5)
                    dev = {nm: round(us, 1) for nm, us in (cs.device_us([call]) or {}).items()}
                    print(f"{what} {name}: {'agrees' if bad is None else bad}, {ms:.4f} ms "
                          f"({100 * b_ms / ms:.1f} % of bound), device µs {dev}, plan {tuple(plan)}",
                          flush=True)
    finally:
        _native._kernels = real
        for attr, value in defaults.items():
            setattr(ttk, attr, value)
        ttk._topk_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
