"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build  — compile the Hopper kernels from hippomm_tpu_torch/csrc with nvcc
  2. kernels — K1 (flash attention) and K2 (fused MLP) against their plain
     PyTorch versions at every shape the ingest path gives them, in bf16;
     kernel, plain and library-call times (CUDA events) beside each bound
  3. tower  — the ImageBind-Huge vision tower through the kernels against the
     same tower with the kernels routed out, on one 32-frame chunk
  4. engine — HippocampalMemory.process_sequence on a 120 s synthetic clip at
     full ImageBind-Huge width (random weights, stub transcriber and clients):
     one ThetaEvent persisted, features checked, and the launch counters
     proving every encoder block of both towers ran through K1 and K2

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`. Writes the same numbers to
chiprun_out/chip_smoke.json. Needs no network and no checkpoint.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor cores


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(fa, shape, gen):
    import torch
    import torch.nn.functional as F

    b, h, tq, tk, hd = shape
    dev = torch.device("cuda")
    q = torch.randn((b, h, tq, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, h, tk, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, h, tk, hd), generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    out = fa.flash_mha(q, k, v, scale)
    torch.cuda.synchronize()
    ref = fa.flash_mha_ref(q, k, v, scale)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > 2e-2:
        fail(f"flash_mha {shape}: max abs err {err} > 2e-2")
    b_ms, b_by = bound(2 * (q.numel() + k.numel() + v.numel() + out.numel()), 4 * b * h * tq * tk * hd)
    return {
        "shape": list(shape), "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_mha(q, k, v, scale)),
        "plain_ms": cuda_ms(lambda: fa.flash_mha_ref(q, k, v, scale), iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_mlp(fm, shape, gen):
    import torch
    import torch.nn.functional as F

    n, d, f = shape
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    w1 = (torch.randn((f, d), generator=gen, device=dev) / math.sqrt(d)).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=gen, device=dev)
    w2 = (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(f)).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=gen, device=dev)
    out = fm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_ref(x, w1, b1, w2, b2)
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f"fused_mlp {shape}: max abs err {err} is {rel:.3g} of max|out| > 2e-2")
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    b_ms, b_by = bound(2 * (2 * n * d + 2 * d * f) + 4 * (f + d), 4 * n * d * f)
    return {
        "shape": list(shape), "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: fm.fused_mlp(x, w1, b1, w2, b2)),
        "plain_ms": cuda_ms(lambda: fm.fused_mlp_ref(x, w1, b1, w2, b2), iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1h)), w2, b2h)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "hippomm_tpu_torch")):
        fail("no hippomm_tpu_torch package beside this script (run it from a checkout)", 2)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card", 3)

    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.media.synth import SynthSpec, generate
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.models.imagebind import model as ib_model
    from hippomm_tpu_torch.ops import _native
    from hippomm_tpu_torch.ops import flash_attention as fa
    from hippomm_tpu_torch.ops import fused_mlp as fm
    from hippomm_tpu_torch.ops.resize import normalize_nchw, resize_crop_u8

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    report = {"card": card, "torch": torch.__version__}

    # 1. build
    t0 = time.perf_counter()
    _native.kernels()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s", flush=True)
    print(_native.build_log, file=sys.stderr, flush=True)

    # 2. kernels against their plain versions at the path shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [check_attention(fa, s, gen) for s in ((32, 16, 257, 257, 80), (96, 12, 229, 230, 64))]
    k2 = [check_mlp(fm, s, gen) for s in ((8224, 1280, 5120), (21984, 768, 3072))]
    for name, rows in (("flash_mha", k1), ("fused_mlp", k2)):
        for r in rows:
            print(f"{name} {r['shape']}: err {r['max_abs_err']:.3g} kernel {r['ms']:.3f} ms "
                  f"plain {r['plain_ms']:.3f} ms library {r['library_ms']:.3f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    # 3. the huge vision tower through the kernels vs with them routed out
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "huge"
    with tempfile.TemporaryDirectory() as store_dir:
        cfg.storage.base_dir = store_dir
        t0 = time.perf_counter()
        mem = HippocampalMemory(cfg)  # CUDA by default
        torch.cuda.synchronize()
        report["init_s"] = time.perf_counter() - t0
        ib = mem.imagebind
        if (ib.cfg.vision.width, ib.cfg.vision.depth, ib.cfg.audio.width, ib.cfg.audio.depth) != (
            1280, 32, 768, 12
        ):
            fail("the engine did not build ImageBind-Huge")
        spec = SynthSpec(duration=120.0, fps=1.0, width=640, height=360, scene_changes=(40.0, 80.0),
                         silence_regions=((59.5, 60.5),))
        clip = generate(spec)
        crops = torch.from_numpy(resize_crop_u8(clip.frames[:32], ib.cfg.image_size)).cuda()
        with torch.no_grad():
            x = normalize_nchw(crops)
            fast = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
            gates = (layers.flash_supported, layers.fused_mlp_supported)
            layers.flash_supported = layers.fused_mlp_supported = lambda *a: False
            try:
                plain = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
            finally:
                layers.flash_supported, layers.fused_mlp_supported = gates
        tower_err = (fast - plain).abs().max().item()
        cos_min = torch.nn.functional.cosine_similarity(fast, plain, dim=-1).min().item()
        print(f"tower: vision embeddings kernels vs plain max abs {tower_err:.3g}, "
              f"min cosine {cos_min:.6f}", flush=True)
        if not (math.isfinite(tower_err) and tower_err <= 2e-2 and cos_min >= 0.999):
            fail(f"vision tower with kernels disagrees with plain: {tower_err}, cos {cos_min}")
        report["tower"] = {"max_abs_err": tower_err, "min_cosine": cos_min}

        # 4. the engine: one clip end to end, counting launches
        fa.flash_mha.launches = 0
        fm.fused_mlp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stms = mem.process_sequence(
            "clip", frame_paths=[f"frames/clip/{i:05d}.jpg" for i in range(len(clip.frames))],
            frame_times=clip.frame_times, frames_rgb=clip.frames, audio_data=clip.audio,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_mha": fa.flash_mha.launches, "fused_mlp": fm.fused_mlp.launches}

        n_frames = sum(len(s.segment_info["frames"]) for s in stms)
        n_vis_chunks = 0
        lo = 0
        while lo < n_frames:
            lo += 128 if n_frames - lo >= 128 else 32
            n_vis_chunks += 1
        n_aud = sum(1 for s in stms if "audio" in s.features)
        expect = n_vis_chunks * ib.cfg.vision.depth + math.ceil(n_aud / 32) * ib.cfg.audio.depth
        print(f"engine: {len(stms)} segments, {n_frames} frames in {n_vis_chunks} vision chunks, "
              f"{n_aud} audio segments; launches {launches}, expected {expect} each; "
              f"wall {wall:.2f} s", flush=True)
        if launches["flash_mha"] != expect or launches["fused_mlp"] != expect:
            fail(f"kernel launches {launches} != {expect}: a block bypassed the kernels")

        events = mem.store.load_all_events()
        if len(events) != 1:
            fail(f"expected one persisted ThetaEvent, found {len(events)}")
        ev = events[0]
        vis, aud = ev.features.get("vision"), ev.features.get("audio")
        if vis is None or aud is None:
            fail(f"ThetaEvent lacks features: {sorted(ev.features)}")
        vnorm = np.linalg.norm(vis, axis=1)
        anorm = np.linalg.norm(aud, axis=1)
        if not (vis.ndim == 2 and vis.shape[1] == 1024 and np.isfinite(vis).all()
                and np.abs(vnorm - 1.0).max() <= 1e-3):
            fail(f"vision features malformed: shape {vis.shape}, norms {vnorm}")
        if not (aud.shape[1] == 1024 and np.isfinite(aud).all() and (anorm > 0).all()
                and (anorm <= 20.0 + 1e-3).all()):
            fail(f"audio features malformed: shape {aud.shape}, norms {anorm}")
        stats = mem.get_stats()
        print("stages: " + json.dumps(stats["timers"]), flush=True)
        report["engine"] = {
            "wall_s": wall, "segments": len(stms), "frames": n_frames, "keyframes": int(vis.shape[0]),
            "audio_rows": int(aud.shape[0]), "launches": launches, "expected_launches": expect,
            "stages": stats["timers"], "media_s": spec.duration,
        }

    sources = {"flash_mha": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "fused_mlp": "hippomm_tpu_torch/csrc/fused_mlp.cu"}
    replaces = {"flash_mha": "hippomm_tpu/ops/flash_attention.py:80",
                "fused_mlp": "hippomm_tpu/ops/fused_mlp.py:123"}
    kernels = []
    for name, rows in (("flash_mha", k1), ("fused_mlp", k2)):
        head = rows[0]  # the vision-tower shape, the larger launch count
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shapes": rows,
        })
    report["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
