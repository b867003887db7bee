"""Time variants of the port's K1/K4 sources (csrc/flash_mha.cu, or with
--f32 csrc/flash_mha_f32.cu) on one CUDA card.

    python3 scripts/torch_flash_variants.py [--f32] [--simt NAME] NAME=SUBS [NAME=SUBS ...]

As scripts/torch_fused_mlp_variants.py, for attention: each NAME=SUBS builds a
copy of hippomm_tpu_torch/csrc/flash_mha.cu (with --f32: flash_mha_f32.cu)
with the text substitutions SUBS applied (``old|||new`` pairs joined by
``;;``; an empty SUBS is the source as it is; ``@FILE`` the source in FILE)
and prints its ptxas registers, spills and notes of serialized wgmma. Then it
runs K1 at the vision, audio and Whisper-encoder shapes and K4 on the vision
tower's packed projection (with --f32: K1 and K4 at chip_smoke.py phase 2's
fp32 path shapes, vision, audio, Whisper and the training step's, on fp32
operands, the plain version in full fp32) through each library in turn,
twice: the max abs error against the plain version, ms per call
(chip_smoke.cuda_ms), device µs per kernel (chip_smoke.device_us), and once
per shape F.scaled_dot_product_attention's ms on the same inputs (fp32,
TF32 off, with --f32). For example, what the exponentials cost (the function
changes, and its error shows it):

    python3 scripts/torch_flash_variants.py 'base=' \\
        'noexp=          const float p = ex2(fmaf(acc[4 * n + e], sl2, neg[e >> 1]));|||          const float p = fmaf(acc[4 * n + e], sl2, neg[e >> 1]);'

--simt NAME runs variant NAME under the 64-row, 64-key plan of the SIMT
fp32 kernel that flash_mha_f32.cu replaced (its C entry takes that plan),
so the two compare in one run on one card (REV: a commit whose
flash_mha_f32.cu is that SIMT kernel):

    git show REV:hippomm_tpu_torch/csrc/flash_mha_f32.cu > _cmp/simt.cu
    python3 scripts/torch_flash_variants.py --f32 --simt simt 'base=' 'simt=@_cmp/simt.cu'
"""

from __future__ import annotations

import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("hmm_flash_mha_bf16", "hmm_flash_mha_bthd_bf16", "hmm_flash_mha_smem_bytes")
K1_SHAPES = [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64)]
K4_SHAPE = (32, 257, 16, 80)
ENTRIES_F32 = ("hmm_flash_mha_f32", "hmm_flash_mha_f32_smem_bytes")
K1_SHAPES_F32 = K1_SHAPES + [(16, 16, 257, 257, 80)]
K4_SHAPES_F32 = [K4_SHAPE, (16, 257, 16, 80)]


def simt_plan(fa):
    """The SIMT kernel's plan: 64 query rows and 64 keys a tile."""

    def plan(tq, tk, hd):
        return fa.AttnPlanF32(tuple((r, 64) for r in range(0, tq, 64)), tuple((j, 64) for j in range(0, tk, 64)),
                              -(-hd // 16), 64)

    return plan


def main(argv) -> int:
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from hippomm_tpu_torch.ops import _native
    from hippomm_tpu_torch.ops import flash_attention as fa

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from torch_fused_mlp_variants import build

    f32 = "--f32" in argv
    argv = [a for a in argv if a != "--f32"]
    simt = None
    if "--simt" in argv:
        i = argv.index("--simt")
        simt = argv[i + 1]
        del argv[i:i + 2]
    variants = dict(a.split("=", 1) for a in argv)
    if f32:
        libs = build(variants, "flash_mha_f32.cu", ENTRIES_F32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        libs = build(variants, "flash_mha.cu", ENTRIES)
    dtype = torch.float32 if f32 else torch.bfloat16
    real, real_plan = _native.kernels(), fa._attn_plan_f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b, h, tq, tk, hd in K1_SHAPES_F32 if f32 else K1_SHAPES:
        q = torch.randn((b, h, tq, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, tk, hd), generator=gen, device="cuda").to(dtype) for _ in range(2))
        cases.append((f"K1 {(b, h, tq, tk, hd)}", fa.flash_mha, fa.flash_mha_ref, (q, k, v), (q, k, v), hd))
    for b, t, h, hd in K4_SHAPES_F32 if f32 else [K4_SHAPE]:
        qkv = torch.randn((b, t, 3 * h * hd), generator=gen, device="cuda").to(dtype)
        q, k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].reshape(b, t, h, hd) for i in range(3))
        cases.append((f"K4 {(b, t, h, hd)} packed", fa.flash_mha_bthd, fa.flash_mha_bthd_ref, (q, k, v),
                      tuple(x.transpose(1, 2) for x in (q, k, v)), hd))
    try:
        for what, kernel, plain, args, sdpa_args, hd in cases:
            scale = 1.0 / math.sqrt(hd)
            want = plain(*args, scale).float()
            lib_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(*sdpa_args, scale=scale), iters=20)
            print(f"{what}: library {lib_ms:.4f} ms", flush=True)
            for _ in range(2):
                for name, lib in libs.items():
                    _native._kernels = lib
                    fa._attn_plan_f32 = simt_plan(fa) if name == simt else real_plan
                    err = (kernel(*args, scale).float() - want).abs().max().item()
                    call = lambda: kernel(*args, scale)  # noqa: E731
                    dev = {n: round(us, 1) for n, us in (cs.device_us([call]) or {}).items()}
                    print(f"{what} {name}: err {err:.3g}, {cs.cuda_ms(call, iters=20):.4f} ms, "
                          f"device µs {dev}", flush=True)
    finally:
        _native._kernels = real
        fa._attn_plan_f32 = real_plan
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
