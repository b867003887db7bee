"""Time variants of the port's K1/K4 source (csrc/flash_mha.cu) on one CUDA card.

    python3 scripts/torch_flash_variants.py NAME=SUBS [NAME=SUBS ...]

As scripts/torch_fused_mlp_variants.py, for attention: each NAME=SUBS builds a
copy of hippomm_tpu_torch/csrc/flash_mha.cu with the text substitutions SUBS
applied (``old|||new`` pairs joined by ``;;``; an empty SUBS is the source as
it is), then runs K1 at the vision, audio and Whisper-encoder shapes and K4 on
the vision tower's packed projection through each library in turn, twice: the
max abs error against the plain version, ms per call (chip_smoke.cuda_ms),
device µs per kernel (chip_smoke.device_us), and once per shape
F.scaled_dot_product_attention's ms on the same inputs. For example, what
the exponentials cost (the function changes, and its error shows it):

    python3 scripts/torch_flash_variants.py 'base=' \\
        'noexp=          const float p = ex2(fmaf(acc[4 * n + e], sl2, neg[e >> 1]));|||          const float p = fmaf(acc[4 * n + e], sl2, neg[e >> 1]);'
"""

from __future__ import annotations

import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("hmm_flash_mha_bf16", "hmm_flash_mha_bthd_bf16", "hmm_flash_mha_smem_bytes")
K1_SHAPES = [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64)]
K4_SHAPE = (32, 257, 16, 80)


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

    libs = build(dict(a.split("=", 1) for a in argv), "flash_mha.cu", ENTRIES)
    real = _native.kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b, h, tq, tk, hd in K1_SHAPES:
        q = torch.randn((b, h, tq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, h, tk, hd), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        cases.append((f"K1 {(b, h, tq, tk, hd)}", fa.flash_mha, fa.flash_mha_ref, (q, k, v), (q, k, v), hd))
    b, t, h, hd = K4_SHAPE
    qkv = torch.randn((b, t, 3 * h * hd), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].reshape(b, t, h, hd) for i in range(3))
    cases.append((f"K4 {K4_SHAPE} packed", fa.flash_mha_bthd, fa.flash_mha_bthd_ref, (q, k, v),
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
                    err = (kernel(*args, scale).float() - want).abs().max().item()
                    call = lambda: kernel(*args, scale)  # noqa: E731
                    dev = {n: round(us, 1) for n, us in (cs.device_us([call]) or {}).items()}
                    print(f"{what} {name}: err {err:.4f}, {cs.cuda_ms(call, iters=20):.4f} ms, "
                          f"device µs {dev}", flush=True)
    finally:
        _native._kernels = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
