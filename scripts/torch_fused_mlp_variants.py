"""Time variants of the port's K2/K3 sources (csrc/fused_mlp.cu, or with
--f32 csrc/fused_mlp_f32.cu) on one CUDA card.

    python3 scripts/torch_fused_mlp_variants.py [--f32] NAME=SUBS [NAME=SUBS ...]

Each NAME=SUBS builds a copy of hippomm_tpu_torch/csrc/fused_mlp.cu (with
--f32: fused_mlp_f32.cu) with the text substitutions SUBS applied
(``old|||new`` pairs joined by ``;;``; an empty SUBS is the source as it
is; ``@FILE`` the source in FILE) into its own library under hippomm_tpu_torch/_build/variants/, then
runs K2 at the vision, audio and Whisper ingest shapes and K3 at the
vision shape (with --f32: K2 and K3 at the fp32 path shapes of
chip_smoke.py phase 2 and an audio shard's 229 rows, on fp32 operands, the
plain version in full fp32) through each library in turn, twice (after
each variant's ptxas registers, spills and notes of serialized wgmma):
the max error against the plain version (relative to max |out|),
ms per call over rotating weight sets (chip_smoke.cuda_ms) and device µs per
kernel (chip_smoke.device_us). A variant that changes the function (an
epilogue taken out) shows it in its error; the times say what the removed
work cost. For example, what pass 1's erf-GELU costs:

    python3 scripts/torch_fused_mlp_variants.py 'base=' \\
        'nogelu=  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));|||  return 0.5f * x;'

and what the fp32 kernels' operand split costs (the values then wrong):

    python3 scripts/torch_fused_mlp_variants.py --f32 'base=' \
        'nosplit=split_tf32<kHalfA / 2048>(|||if (false) split_tf32<kHalfA / 2048>(;;split_tf32<kHalfB / 2048>(|||if (false) split_tf32<kHalfB / 2048>('
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("hmm_fused_mlp_bf16", "hmm_fused_ln_mlp_residual_bf16", "hmm_fused_mlp_smem_bytes")
SHAPES = [((8224, 1280, 5120), False), ((21984, 768, 3072), False), ((6000, 1280, 5120), False),
          ((8224, 1280, 5120), True)]
ENTRIES_F32 = ("hmm_fused_mlp_f32", "hmm_fused_ln_mlp_residual_f32", "hmm_fused_mlp_f32_smem_bytes")
SHAPES_F32 = [(s, ln) for ln in (False, True) for s in (
    (8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120), (77, 1024, 4096), (616, 1024, 4096),
    (4112, 1280, 5120), (1232, 1024, 4096), (229, 768, 3072))]


def build(variants: dict, source: str = "fused_mlp.cu", entries=ENTRIES) -> dict:
    """One shared library per variant of csrc/`source` (SUBS `@FILE`: the
    source in FILE instead), all nvcc processes started together; each
    binds `entries` as the kernel library does."""
    from hippomm_tpu_torch.ops import _native

    src = open(os.path.join(_native._CSRC, source)).read()
    out_dir = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    flags = _native.NVCC_FLAGS
    procs = {}
    for name, subs in variants.items():
        text = src
        if subs.startswith("@"):  # a whole source from a file, e.g. an earlier commit's (git show)
            with open(subs[1:]) as f:
                text, subs = f.read(), ""
        for sub in filter(None, subs.split(";;")):
            old, new = sub.split("|||")
            if old not in text:
                sys.exit(f"variant {name}: {old!r} is not in csrc/{source}")
            text = text.replace(old, new)
        cu, lib = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen(
            [_native._nvcc(), *flags, "-I", _native._CSRC, "-shared", "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    real = _native.kernels()
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name} does not build:\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(r) for r in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"variant {name}: registers {regs}, spill stores {spills}, "
              f"{log.count('wgmma.mma_async instructions are serialized')} ptxas notes of serialized wgmma",
              flush=True)
        lib = ctypes.CDLL(path)
        for fn in entries:
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    return libs


def main(argv) -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from hippomm_tpu_torch.ops import _native
    from hippomm_tpu_torch.ops import fused_mlp as fm

    f32 = "--f32" in argv
    argv = [a for a in argv if a != "--f32"]
    if f32:
        libs = build(dict(a.split("=", 1) for a in argv), "fused_mlp_f32.cu", ENTRIES_F32)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        libs = build(dict(a.split("=", 1) for a in argv))
    real = _native.kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.float32 if f32 else torch.bfloat16
    try:
        for shape, ln in SHAPES_F32 if f32 else SHAPES:
            n, d, f = shape
            sets = cs.operand_sets(lambda: cs.mlp_operands(shape, gen, ln, dtype), 2 * dtype.itemsize * d * f)
            kernel = fm.fused_ln_mlp_residual if ln else fm.fused_mlp
            tail = (1e-6,) if ln else ()
            want = (fm.fused_ln_mlp_residual_ref if ln else fm.fused_mlp_ref)(*sets[0], *tail).float()
            calls = [lambda s=s: kernel(*s, *tail) for s in sets]
            for _ in range(2):
                for name, lib in libs.items():
                    _native._kernels = lib
                    rel = ((kernel(*sets[0], *tail).float() - want).abs().max() / want.abs().max()).item()
                    dev = {k: round(v, 1) for k, v in (cs.device_us(calls) or {}).items()}
                    print(f"{'K3' if ln else 'K2'} {shape} {name}: rel err {rel:.3g}, "
                          f"{cs.cuda_ms(calls, iters=24):.4f} ms, device µs {dev}", flush=True)
    finally:
        _native._kernels = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
