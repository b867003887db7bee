"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build  — compile the Hopper kernels from hippomm_tpu_torch/csrc with nvcc
  2. kernels — K1 (flash attention), K2 (fused MLP), K3 (LN+MLP+residual)
     and K4 (attention in the (B, T, H, hd) layout) against their plain
     PyTorch versions at every shape the ingest path gives them, in bf16;
     kernel, plain and library-call times (CUDA events) beside each bound
  3. towers — the ImageBind-Huge vision tower through the kernels, in the
     default and in the fused-block configuration, and the Whisper
     distil-large-v3 encoder through the kernels, each against the same
     forward with the kernels routed out
  4. engine — HippocampalMemory.process_sequence on a 120 s synthetic clip at
     full ImageBind-Huge and Whisper distil-large-v3 width (random weights
     from a seed, stub clients): one ThetaEvent persisted, features checked,
     the transcribe stage timed, and the launch counters proving every
     encoder block of all three towers ran through K1 and K2
  5. fused  — the same engine and weights on the same clip under a new video
     id with HIPPOMM_FUSED_BLOCK=1 and HIPPOMM_FLASH_BTHD=1: every ImageBind
     block through K3, every vision block through K4, the rest through K1/K2;
     features agree with phase 4 and the transcript token ids are equal

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


def check_ln_mlp(fm, shape, gen):
    import torch
    import torch.nn.functional as F

    n, d, f = shape
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    beta = 0.1 * torch.randn((d,), generator=gen, device=dev)
    w1 = (torch.randn((f, d), generator=gen, device=dev) / math.sqrt(d)).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=gen, device=dev)
    w2 = (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(f)).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=gen, device=dev)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    out = fm.fused_ln_mlp_residual(*args)
    torch.cuda.synchronize()
    ref = fm.fused_ln_mlp_residual_ref(*args)
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f"fused_ln_mlp_residual {shape}: max abs err {err} is {rel:.3g} of max|out| > 2e-2")
    g16, bt16, b1h, b2h = (t.to(torch.bfloat16) for t in (gamma, beta, b1, b2))

    def library():
        h = F.layer_norm(x, (d,), g16, bt16, 1e-6)
        return x + F.linear(F.gelu(F.linear(h, w1, b1h)), w2, b2h)

    # x read and out written once, W1 and W2 once, the (D,)/(F,) vectors once
    b_ms, b_by = bound(2 * (2 * n * d + 2 * d * f) + 4 * (f + 3 * d), 4 * n * d * f)
    return {
        "shape": list(shape), "max_abs_err": err, "rel_err": rel,
        "ms": cuda_ms(lambda: fm.fused_ln_mlp_residual(*args)),
        "plain_ms": cuda_ms(lambda: fm.fused_ln_mlp_residual_ref(*args), iters=3, warmup=1),
        "library_ms": cuda_ms(library),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_attention_bthd(fa, shape, gen):
    """K4 on q/k/v slices of one packed (B, T, 3D) projection — row stride
    3D, the views the attention route hands it."""
    import torch
    import torch.nn.functional as F

    b, t, h, hd = shape
    d = h * hd
    dev = torch.device("cuda")
    qkv = torch.randn((b, t, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * d : (i + 1) * d].reshape(b, t, h, hd) for i in range(3))
    scale = 1.0 / math.sqrt(hd)
    out = fa.flash_mha_bthd(q, k, v, scale)
    torch.cuda.synchronize()
    ref = fa.flash_mha_bthd_ref(q, k, v, scale)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > 2e-2:
        fail(f"flash_mha_bthd {shape}: max abs err {err} > 2e-2")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = bound(2 * 4 * b * t * d, 4 * b * h * t * t * hd)
    return {
        "shape": list(shape), "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_mha_bthd(q, k, v, scale)),
        "plain_ms": cuda_ms(lambda: fa.flash_mha_bthd_ref(q, k, v, scale), iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def set_fused_flags(fa, fm, on: bool) -> None:
    """HIPPOMM_FUSED_BLOCK / HIPPOMM_FLASH_BTHD as a user sets them, then the
    cached route policies re-read."""
    for flag in ("HIPPOMM_FUSED_BLOCK", "HIPPOMM_FLASH_BTHD"):
        if on:
            os.environ[flag] = "1"
        else:
            os.environ.pop(flag, None)
    fa.bthd_default.cache_clear()
    fm.fused_block_default.cache_clear()


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
    from hippomm_tpu_torch.models.whisper import model as wh_model
    from hippomm_tpu_torch.models.whisper import transcribe as wh_transcribe
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
    rows = {
        # ImageBind vision, audio trunk (bias_kv), Whisper encoder (4 chunks)
        "flash_mha": [check_attention(fa, s, gen) for s in (
            (32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64))],
        "fused_mlp": [check_mlp(fm, s, gen) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120))],
        "fused_ln_mlp_residual": [check_ln_mlp(fm, s, gen) for s in (
            (8224, 1280, 5120), (21984, 768, 3072))],
        "flash_mha_bthd": [check_attention_bthd(fa, (32, 257, 16, 80), gen)],
    }
    for name, rs in rows.items():
        for r in rs:
            print(f"{name} {r['shape']}: err {r['max_abs_err']:.3g} kernel {r['ms']:.3f} ms "
                  f"plain {r['plain_ms']:.3f} ms library {r['library_ms']:.3f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "huge"
    cfg.models.whisper_variant = "distil-large-v3"
    cfg.models.whisper_random_init = True
    with tempfile.TemporaryDirectory() as store_dir:
        cfg.storage.base_dir = store_dir
        t0 = time.perf_counter()
        mem = HippocampalMemory(cfg)  # CUDA by default
        torch.cuda.synchronize()
        report["init_s"] = time.perf_counter() - t0
        ib, wh = mem.imagebind, mem.whisper
        if (ib.cfg.vision.width, ib.cfg.vision.depth, ib.cfg.audio.width, ib.cfg.audio.depth) != (
            1280, 32, 768, 12
        ):
            fail("the engine did not build ImageBind-Huge")
        wcfg = wh.cfg
        if wcfg is None or (wcfg.d_model, wcfg.encoder_layers, wcfg.decoder_layers, wcfg.heads,
                            wcfg.ffn, wcfg.vocab_size, wcfg.n_mels) != (
                                1280, 32, 2, 20, 5120, 51866, 128):
            fail(f"the engine did not build Whisper distil-large-v3: {wcfg}")
        spec = SynthSpec(duration=120.0, fps=1.0, width=640, height=360, scene_changes=(40.0, 80.0),
                         silence_regions=((59.5, 60.5),))
        clip = generate(spec)

        # 3. the towers through the kernels vs with them routed out
        crops = torch.from_numpy(resize_crop_u8(clip.frames[:32], ib.cfg.image_size)).cuda()
        wt = wh._impl
        pcm = torch.from_numpy(clip.audio[: 30 * 16000].astype(np.float32)).cuda()
        with torch.no_grad():
            x = normalize_nchw(crops)
            mel = wt.mel(pcm[None])[:, :, : 2 * wcfg.max_source_positions]
            fast = {"vision": ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype),
                    "whisper_encoder": wh_model.encoder_forward(wt.params, mel, wcfg, wt.dtype)[0]}
            set_fused_flags(fa, fm, True)
            fast["vision_fused"] = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
            set_fused_flags(fa, fm, False)
            gates = (layers.flash_supported, layers.fused_mlp_supported)
            layers.flash_supported = layers.fused_mlp_supported = lambda *a: False
            try:
                plain = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
                plain_enc = wh_model.encoder_forward(wt.params, mel, wcfg, wt.dtype)[0]
            finally:
                layers.flash_supported, layers.fused_mlp_supported = gates
        report["towers"] = {}
        for name, got in fast.items():
            want = plain_enc if name == "whisper_encoder" else plain
            err = (got - want).abs().max().item()
            cos_min = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
            # the towers' heads are unit-norm: 2e-2 abs. The encoder's output
            # is its final LN of a bf16 residual stream 32 layers deep, whose
            # values reach 8-16 (bf16 ulp 0.0625), so kernel-vs-plain
            # rounding differences compound to a few percent of max |out|:
            # 5e-2 of it, beside the same cosine gate
            lim = 5e-2 * want.abs().max().item() if name == "whisper_encoder" else 2e-2
            print(f"tower {name}: kernels vs plain max abs {err:.3g} (limit {lim:.3g}), "
                  f"min cosine {cos_min:.6f}", flush=True)
            if not (math.isfinite(err) and err <= lim and cos_min >= 0.999):
                fail(f"{name} with kernels disagrees with plain: {err}, cos {cos_min}")
            report["towers"][name] = {"max_abs_err": err, "limit": lim, "min_cosine": cos_min}

        # the decoder's token ids and steps, as the transcriber gets them
        decodes = []
        real_greedy = wh_transcribe.greedy_decode

        def greedy_spy(*a, **k):
            tokens, lengths = real_greedy(*a, **k)
            decodes.append((tokens.cpu().numpy(), lengths.cpu().numpy()))
            return tokens, lengths

        wh_transcribe.greedy_decode = greedy_spy
        counters = {"flash_mha": fa.flash_mha, "fused_mlp": fm.fused_mlp,
                    "fused_ln_mlp_residual": fm.fused_ln_mlp_residual,
                    "flash_mha_bthd": fa.flash_mha_bthd}
        n_chunks = math.ceil(len(clip.audio) / (30 * 16000))
        enc_batches = math.ceil(n_chunks / 32)
        paths = {}
        try:
            for phase, video_id, fused in (("default", "clip", False), ("fused", "clip_fused", True)):
                set_fused_flags(fa, fm, fused)
                decodes.clear()
                stages_before = dict(mem.timers.totals)
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stms = mem.process_sequence(
                    video_id,
                    frame_paths=[f"frames/{video_id}/{i:05d}.jpg" for i in range(len(clip.frames))],
                    frame_times=clip.frame_times, frames_rgb=clip.frames, audio_data=clip.audio,
                )
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {name: c.launches for name, c in counters.items()}
                n_frames = sum(len(s.segment_info["frames"]) for s in stms)
                n_vis_chunks, lo = 0, 0
                while lo < n_frames:
                    lo += 128 if n_frames - lo >= 128 else 32
                    n_vis_chunks += 1
                n_aud = sum(1 for s in stms if "audio" in s.features)
                vis_blocks = n_vis_chunks * ib.cfg.vision.depth
                aud_blocks = math.ceil(n_aud / 32) * ib.cfg.audio.depth
                wh_blocks = enc_batches * wcfg.encoder_layers
                if fused:  # K3 every ImageBind block, K4 the vision blocks (H 16)
                    expect = {"flash_mha": aud_blocks + wh_blocks, "fused_mlp": wh_blocks,
                              "fused_ln_mlp_residual": vis_blocks + aud_blocks,
                              "flash_mha_bthd": vis_blocks}
                else:
                    expect = {"flash_mha": vis_blocks + aud_blocks + wh_blocks,
                              "fused_mlp": vis_blocks + aud_blocks + wh_blocks,
                              "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}
                if len(decodes) != enc_batches:
                    fail(f"{phase}: {len(decodes)} Whisper decodes for {enc_batches} encoder batches")
                plen = len(wt._prompt()[0])
                steps = [min(int(ln.max()) + 1, tok.shape[1]) - plen for tok, ln in decodes]
                token_ids = [[tok[j, : int(ln[j])].tolist() for j in range(tok.shape[0])]
                             for tok, ln in decodes]
                for tok, ln in decodes:
                    if not ((tok >= 0).all() and (tok < wcfg.vocab_size).all()
                            and (ln >= plen).all() and (ln <= tok.shape[1]).all()):
                        fail(f"{phase}: Whisper decode out of range: lengths {ln}")
                stages = {k: v - stages_before.get(k, 0.0) for k, v in mem.timers.totals.items()}
                transcribe_s = stages["transcribe"]
                print(f"engine {phase}: {len(stms)} segments, {n_frames} frames in {n_vis_chunks} "
                      f"vision chunks, {n_aud} audio segments, {n_chunks} ASR chunks in "
                      f"{enc_batches} encoder batches; launches {launches}, expected {expect}; "
                      f"decode steps {steps}; transcribe {transcribe_s:.3f} s; wall {wall:.2f} s",
                      flush=True)
                print(f"stages {phase}: " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
                      flush=True)
                if launches != expect:
                    fail(f"{phase}: kernel launches {launches} != {expect}: a block bypassed its kernel")
                paths[phase] = {
                    "wall_s": wall, "segments": len(stms), "frames": n_frames,
                    "vision_chunks": n_vis_chunks, "audio_segments": n_aud, "asr_chunks": n_chunks,
                    "encoder_batches": enc_batches, "launches": launches, "expected_launches": expect,
                    "decode_steps": steps, "transcribe_s": transcribe_s, "stages_s": stages,
                    "token_ids": token_ids, "stms": stms,
                }
        finally:
            wh_transcribe.greedy_decode = real_greedy
            set_fused_flags(fa, fm, False)

        # the persisted events: one per video, well-formed features
        events = {ev.video_id: ev for ev in mem.store.load_all_events()}
        if sorted(events) != ["clip", "clip_fused"]:
            fail(f"expected the ThetaEvents of clip and clip_fused, found {sorted(events)}")
        for ev in events.values():
            vis, aud = ev.features.get("vision"), ev.features.get("audio")
            if vis is None or aud is None:
                fail(f"ThetaEvent {ev.video_id} lacks features: {sorted(ev.features)}")
            vnorm = np.linalg.norm(vis, axis=1)
            anorm = np.linalg.norm(aud, axis=1)
            if not (vis.ndim == 2 and vis.shape[1] == 1024 and np.isfinite(vis).all()
                    and np.abs(vnorm - 1.0).max() <= 1e-3):
                fail(f"vision features malformed: shape {vis.shape}, norms {vnorm}")
            if not (aud.shape[1] == 1024 and np.isfinite(aud).all() and (anorm > 0).all()
                    and (anorm <= 20.0 + 1e-3).all()):
                fail(f"audio features malformed: shape {aud.shape}, norms {anorm}")

        # 5. the fused configuration against the default one
        agree = {}
        for mod, norm in (("vision", 1.0), ("audio", 20.0)):
            a = np.concatenate([s.features[mod] for s in paths["default"]["stms"] if mod in s.features])
            b = np.concatenate([s.features[mod] for s in paths["fused"]["stms"] if mod in s.features])
            if a.shape != b.shape:
                fail(f"fused {mod} features {b.shape} != default {a.shape}")
            err = float(np.abs(a - b).max()) / norm
            cos = float((np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())
            agree[mod] = {"max_abs_err": err, "min_cosine": cos}
            print(f"fused vs default {mod} features (÷{norm:g}): max abs {err:.3g}, min cosine "
                  f"{cos:.6f}", flush=True)
            if not (math.isfinite(err) and err <= 2e-2 and cos >= 0.999):
                fail(f"fused {mod} features disagree with the default configuration: {err}, cos {cos}")
        if paths["fused"]["token_ids"] != paths["default"]["token_ids"]:
            fail("the fused configuration's transcript token ids differ from the default one's")
        print("fused vs default transcript token ids: equal", flush=True)
        stats = mem.get_stats()
        print("stages: " + json.dumps(stats["timers"]), flush=True)
        for ph in paths.values():
            ph.pop("stms")
        report["engine"] = {"paths": paths, "fused_vs_default": agree, "stages": stats["timers"],
                            "media_s": spec.duration}

    sources = {"flash_mha": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "fused_mlp": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "fused_ln_mlp_residual": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "flash_mha_bthd": "hippomm_tpu_torch/csrc/flash_mha.cu"}
    replaces = {"flash_mha": "hippomm_tpu/ops/flash_attention.py:80",
                "fused_mlp": "hippomm_tpu/ops/fused_mlp.py:123",
                "fused_ln_mlp_residual": "hippomm_tpu/ops/fused_mlp.py:153",
                "flash_mha_bthd": "hippomm_tpu/ops/flash_attention.py:319"}
    # each kernel's own path: K1/K2 the default configuration, K3/K4 the fused one
    own_path = {"flash_mha": "default", "fused_mlp": "default",
                "fused_ln_mlp_residual": "fused", "flash_mha_bthd": "fused"}
    kernels = []
    for name, rs in rows.items():
        head = rs[0]  # the vision-tower shape, the largest launch count
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": paths[own_path[name]]["launches"][name],
            "launches_by_path": {ph: paths[ph]["launches"][name] for ph in paths},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shapes": rs,
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
