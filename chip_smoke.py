"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build  — compile the Hopper kernels from hippomm_tpu_torch/csrc with nvcc
  2. kernels — K1 (flash attention), K2 (fused MLP), K3 (LN+MLP+residual)
     and K4 (attention in the (B, T, H, hd) layout) against their plain
     PyTorch versions at every shape the ingest and query paths give them,
     in bf16, and K5 (cosine top-k) in fp32 at stores of 2e5 and 1e6 rows
     and an ascending-sorted 2e5 store;
     kernel, plain and library-call times (CUDA events) beside each bound
     and its share of it; K2/K3 and their library calls timed over rotating
     weight sets that overflow the L2 (as each encoder block finds its
     weights cold), the median of 5 such timings, with their tile plan,
     CUDA kernels per call, device µs per kernel (torch.profiler), host µs
     to enqueue a call; the same readings for K1/K4 (one launch per call,
     warm inputs, the median of 5 timings) and K5 (its plan, kernels per
     call from the profiler: never more than one) with their plans; ptxas's registers, spills
     and shared memory for every kernel of csrc/*.cu
  3. towers — the ImageBind-Huge vision and text towers through the
     kernels, in the default and in the fused-block configuration, and the
     Whisper distil-large-v3 encoder through the kernels, each against the
     same forward with the kernels routed out
  4. engine — HippocampalMemory.process_sequence on a 120 s synthetic clip at
     full ImageBind-Huge and Whisper distil-large-v3 width (random weights
     from a seed, stub clients): one ThetaEvent persisted, features checked,
     the transcribe stage timed, and the launch counters proving every
     encoder block of all three towers ran through K1 and K2
  5. fused  — the same engine and weights on the same clip under a new video
     id with HIPPOMM_FUSED_BLOCK=1 and HIPPOMM_FLASH_BTHD=1: every ImageBind
     block through K3, every vision block through K4, the rest through K1/K2;
     features agree with phase 4 and the transcript token ids are equal
  8. cli    — (runs after phase 5, before the query phase) the ingest CLI
     core/batch_process.main over a folder of two seeded 640×360 clips with
     sibling 16 kHz WAVs: long.y4m (120 s at 4 fps, 120 candidates: the
     vision stream fed key frames as their scan masks are read) and
     short.avi (30 s, MJPEG; short.y4m where the media shim did not build:
     every candidate encoded); main builds its own engine on the card at
     full ImageBind-Huge and distil-large-v3 width (random weights, stub
     clients). Exact K1/K2 launch counts (vision ceil(fed/32)·32 blocks a
     video), each video's card key-frame mask against the CPU scan of the
     same luma, the stream's features against a one-shot encode_vision, a
     second run skipped, and the chunked streaming path's key frames against
     the whole-video pass; per-video wall, realtime multiple, every stage's
     seconds, the mask-read wait per block, and the scan alone (warm, on
     long.y4m's luma: host ms and CUDA kernels per candidate)
  6. query  — core/ask_question over the store phases 4 and 5 wrote, with
     detailed recall forced (fast_path_confidence 2.0) and the search route
     left as a user's call finds it (no HIPPOMM_TOPK_ROUTE): a VIDEO, an
     AUDIO "sound" and a SUMMARY question and an 8-question batch, then the
     VIDEO question under the fused flags; exact launch counts (K2, or K3,
     24 per text forward; K5 one per single-query search round, every round
     on the device; K1/K2 only for the Whisper re-transcription), every
     search's hits against the host route's (compare_hits), per-question
     wall and stage seconds
  9. serve  — (runs after phase 6) the QA server core/serve started from a
     file: a seeded full-width ImageBind-Huge checkpoint written from the
     port's manifest as fp32 .pth (4.3 GB), Whisper distil-large-v3 random
     weights, stub clients, detailed recall forced, an empty store.
     QAService on the card: its towers' vision and text features equal
     (max abs 0) to towers carried from the same numpy weights; startup
     seconds (read, convert, carry to the card) and peak RSS. Then over
     HTTP on a server thread: /ingest of a folder of two seeded 640×360
     clips (.mp4 with the audio embedded where the libav shim loads, else
     .y4m with sibling .wav files) and of one more file, exact K1/K2
     counts by phase 8's formula; /healthz and /events show 3 events; /ask
     the VIDEO, SOUND and SUMMARY questions and /ask_batch the 8, exact K2
     and K5 counts by phase 6's formulas, every search's hits against the
     host route; 4 concurrent /ask, the latency histogram (ask count ≥ 7,
     p95 ≥ p50); a corrupt .mp4 to /ingest gives 500 and leaves the engine
     clean. Last, a restart over the 3-event store with the checkpoint's
     pages dropped from the page cache: load (from the disk) and warmup
     seconds
  7. search — a FeatureSearchIndex of 200 000 × 1024 seeded rows (100
     events of 2000): 64 single-query searches through K5 and one batch of
     64, ms per query, 4 queries' hits and times on the host route

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`. Writes the same numbers to
chiprun_out/chip_smoke.json. Needs no network and no checkpoint.
Phase 9 writes its own checkpoint file from a seed.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOP_S = 67e12  # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50e6  # H100 L2 cache
TEXT_DEPTH = 24  # ImageBind-Huge text blocks: one K2 (or K3) launch each per forward
WHISPER_DEPTH = 32  # distil-large-v3 encoder blocks: one K1 and one K2 each per batch
VIDEO_Q = "What color is the moving square?"
SOUND_Q = "What sound plays in the background?"
SUMMARY_Q = "What is the overall summary of the video?"
BATCH_QS = [VIDEO_Q, "What objects appear on screen?", "Where is the red block?",
            "What shape is in the corner?", "What is drawn at the top?", "Which colors are shown?",
            "What moves across the frame?", "What is in the middle of the picture?"]


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_ms(fn, iters: int = 10, warmup: int = 2, repeats: int = 1) -> float:
    """Mean ms per launch over `iters` launches after `warmup`, CUDA events;
    with `repeats` > 1, the median of that many such means (a call whose
    time is the host's, as at the text tower's rows, then reads past the
    host's passing stalls). `fn` may be a list of closures over distinct
    operand sets, called in turn (iters and warmup rounded up to whole
    turns)."""
    import statistics

    import torch

    fns = fn if isinstance(fn, list) else [fn]
    turns = -(-iters // len(fns))
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(turns):
            for f in fns:
                f()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / (turns * len(fns)))
    return statistics.median(means)


def operand_sets(make, weight_bytes: float):
    """Enough operand sets from `make()` that a turn of one launch per set
    reads 1.3× the 50 MB L2 in weights: each launch finds its weights cold,
    as each encoder block of a tower does (its own weights)."""
    return [make() for _ in range(max(1, math.ceil(1.3 * L2_BYTES / weight_bytes)))]


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_BF16_FLOP_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
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
    return attention_row(fa, shape, err, lambda: fa.flash_mha(q, k, v, scale),
                         lambda: fa.flash_mha_ref(q, k, v, scale),
                         lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), b_ms, b_by,
                         (tq, tk, hd))


def attention_row(fa, shape, err, kernel, plain, library, b_ms, b_by, plan_shape):
    """K1/K4's phase-2 readings: kernel, plain and library ms, the bound and
    its share, the tile plan, CUDA kernels per call, device µs per kernel
    (torch.profiler) and host µs to enqueue a call."""
    plan = fa._attn_plan(*plan_shape)
    row = {
        "shape": list(shape), "max_abs_err": err,
        "ms": cuda_ms(kernel, iters=20, repeats=5),
        "plain_ms": cuda_ms(plain, iters=3, warmup=1),
        "library_ms": cuda_ms(library, iters=20, repeats=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "plan": {"q_tiles": len(plan.q_tiles), "key_tiles": [w for _, w in plan.key_tiles],
                 "panels": [w for _, _, w in plan.panels]},
        "kernels_per_call": 1,
    }
    row["pct_of_bound"] = 100.0 * b_ms / row["ms"]
    row["device_us"] = device_us([kernel])
    row["host_us"] = host_us([kernel])
    return row


def mlp_operands(shape, gen, ln: bool):
    """x, (gamma, beta,) w1, b1, w2, b2 of one K2 (ln False) or K3 call."""
    import torch

    n, d, f = shape
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    norm = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev),
            0.1 * torch.randn((d,), generator=gen, device=dev)) if ln else ()
    w1 = (torch.randn((f, d), generator=gen, device=dev) / math.sqrt(d)).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=gen, device=dev)
    w2 = (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(f)).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=gen, device=dev)
    return (x, *norm, w1, b1, w2, b2)


def check_mlp_kernel(fm, shape, gen, ln: bool):
    """K2 (ln False) or K3 against its plain version on one operand set,
    then kernel, plain and library times cycling through weight sets that
    overflow the L2 (each launch finds its weights cold, as on the path)."""
    import torch
    import torch.nn.functional as F

    n, d, f = shape
    name = "fused_ln_mlp_residual" if ln else "fused_mlp"
    kernel = fm.fused_ln_mlp_residual if ln else fm.fused_mlp
    plain = fm.fused_ln_mlp_residual_ref if ln else fm.fused_mlp_ref
    tail = (1e-6,) if ln else ()
    sets = operand_sets(lambda: mlp_operands(shape, gen, ln), 4 * d * f)
    out = kernel(*sets[0], *tail)
    torch.cuda.synchronize()
    ref = plain(*sets[0], *tail)
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f"{name} {shape}: max abs err {err} is {rel:.3g} of max|out| > 2e-2")

    def library(x, *rest):
        # the cuBLAS chain in bf16 (biases and the LN affine cast to bf16)
        g16, bt16, w1, b1h, w2, b2h = rest if ln else (None, None, *rest)
        h = F.layer_norm(x, (d,), g16, bt16, 1e-6) if ln else x
        y = F.linear(F.gelu(F.linear(h, w1, b1h)), w2, b2h)
        return x + y if ln else y

    lib_args = [tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t for t in s) for s in sets]
    # x read and out written once, W1 and W2 once, the (D,)/(F,) vectors once
    b_ms, b_by = bound(2 * (2 * n * d + 2 * d * f) + 4 * (f + (3 if ln else 1) * d), 4 * n * d * f)
    plan = fm._plan(n, d, f)
    row = {
        "shape": list(shape), "max_abs_err": err, "rel_err": rel, "operand_sets": len(sets),
        "plan": plan._asdict(), "kernels_per_call": fm.kernels_per_call(plan, ln),
        "ms": cuda_ms([lambda s=s: kernel(*s, *tail) for s in sets], repeats=5),
        "plain_ms": cuda_ms([lambda s=s: plain(*s, *tail) for s in sets], iters=3, warmup=1),
        "library_ms": cuda_ms([lambda a=a: library(*a) for a in lib_args], repeats=5),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["pct_of_bound"] = 100.0 * b_ms / row["ms"]
    row["device_us"] = device_us([lambda s=s: kernel(*s, *tail) for s in sets])
    row["host_us"] = host_us([lambda s=s: kernel(*s, *tail) for s in sets])
    return row


def host_us(fns, turns: int = 10) -> float:
    """Mean host µs to enqueue one call (no synchronize inside the turns):
    the wrapper's Python, ctypes and launches. Where it exceeds the device
    µs, the event-timed ms is the host's."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(turns):
        for f in fns:
            f()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / (turns * len(fns))


def device_us(fns, turns: int = 3):
    """Mean device µs per call of each CUDA kernel the calls launch (short
    names), from torch.profiler over `turns` turns of `fns`; their sum beside
    the event-timed ms shows the host's share. None if the profiler records
    no device time."""
    return profile_kernels(fns, turns)[0]


def profile_kernels(fns, turns: int = 3):
    """device_us, and the CUDA kernels launched per call (None without
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(turns):
            for f in fns:
                f()
        torch.cuda.synchronize()
    calls, out, launched = turns * len(fns), {}, 0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0 and "(" in e.key:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + us / calls
            launched += e.count
    return out or None, (launched / calls if out else None)


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
    return attention_row(fa, shape, err, lambda: fa.flash_mha_bthd(q, k, v, scale),
                         lambda: fa.flash_mha_bthd_ref(q, k, v, scale),
                         lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), b_ms, b_by,
                         (t, t, hd))


def topk_mismatch(vals, idx, rvals, ridx, tol: float = 1e-5):
    """None when the two top-k results agree: values within tol, indices
    equal except where the plain version's neighbouring values are closer
    than tol (an order the two roundings may flip); else what differs."""
    vals, rvals = vals.double().cpu(), rvals.double().cpu()
    idx, ridx = idx.long().cpu(), ridx.long().cpu()
    err = (vals - rvals).abs().max().item()
    if not err <= tol:
        return f"values differ by {err}"
    gaps = (rvals[1:] - rvals[:-1]).abs()
    for j in (idx != ridx).nonzero().flatten().tolist():
        near = ([gaps[j - 1].item()] if j > 0 else []) + ([gaps[j].item()] if j < len(gaps) else [])
        if min(near, default=float("inf")) >= tol:
            return f"index {j}: {idx[j].item()} != {ridx[j].item()}"
    return None


def check_topk(ttk, shape, gen, ascending: bool = False):
    """K5 over a store of unit rows (as the search route normalizes it once
    at upload) and a random query; with `ascending`, the rows sorted by
    their similarity to it, lowest first (every row beats each block's
    running threshold: the filter's worst case). Kernel, plain and library
    ms, its plan, CUDA kernels per call, device µs per kernel
    (torch.profiler) and host µs to enqueue a call."""
    import torch

    n, d, k = shape
    dev = torch.device("cuda")
    feats = torch.randn((n, d), generator=gen, device=dev)
    feats /= feats.norm(dim=1, keepdim=True)
    q = torch.randn((d,), generator=gen, device=dev)
    qn = q / q.norm().clamp_min(1e-8)
    if ascending:
        feats = feats[torch.argsort(feats @ qn)].contiguous()
    vals, idx = ttk.top_k_cosine_kernel(q, feats, k)
    torch.cuda.synchronize()
    rvals, ridx = ttk.top_k_cosine_ref(q, feats, k)
    bad = topk_mismatch(vals, idx, rvals, ridx)
    if bad:
        fail(f"top_k_cosine {shape}{' ascending' if ascending else ''}: {bad}")
    # the store read once, q read and k values + k indices written once;
    # 4 flops per element (dot and sum of squares) on the fp32 CUDA cores
    b_ms, b_by = bound(4 * n * d + 4 * d + 8 * k, 4 * n * d, PEAK_FP32_FLOP_S)
    kernel = lambda: ttk.top_k_cosine_kernel(q, feats, k)  # noqa: E731
    us, per_call = profile_kernels([kernel])
    row = {
        "shape": list(shape), "ascending": ascending, "max_abs_err": (vals - rvals).abs().max().item(),
        "ms": cuda_ms(kernel, iters=20, repeats=5),
        "plain_ms": cuda_ms(lambda: ttk.top_k_cosine_ref(q, feats, k), iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.topk(feats @ qn, k), iters=20, repeats=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "plan": ttk._topk_plan(n, d, k, torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        "kernels_per_call": per_call, "device_us": us, "host_us": host_us([kernel]),
    }
    # the trace may drop an event (a reading under one is the profiler's);
    # more than one kernel a call would be the wrapper's
    if per_call is not None and per_call > 1:
        fail(f"top_k_cosine {shape}: {per_call} CUDA kernels per call, not one")
    return row


_EPILOGUES = {"0": "gelu", "1": "bias", "2": "bias+residual", "3": "fp32 partial"}


def build_report(native, topk_plan):
    """Registers, spills and shared memory of each kernel of csrc/*.cu, from
    ptxas -v in the build log; the dynamic shared memory of an attention
    block (at its hd) and of a GEMM pass (its ring at that tile width) from
    the library, and of a K5 block from `topk_plan` (the 2e5-row store's)."""
    import re

    out = []
    for source in ("flash_mha.cu", "fused_mlp.cu", "topk_cosine.cu"):
        log = native.build_log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
        for block in log.split("Compiling entry function '")[1:]:
            mangled = block.split("'", 1)[0]
            attn = re.search(r"flash_mha_kernelILi(\d+)E", mangled)
            gemm = re.search(r"gemm_tnILi(\d+)ELi(\d+)E", mangled)
            kind = re.search(r"\d+(layer_norm_rows|splitk_reduce)E", mangled)
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            smem = re.search(r"(\d+) bytes smem", block)
            if attn:
                name, dyn = f"flash_mha_kernel<hd {attn.group(1)}>", native.kernels().hmm_flash_mha_smem_bytes(
                    int(attn.group(1)))
            elif gemm:
                name = f"gemm_tn<BN {gemm.group(1)}, {_EPILOGUES[gemm.group(2)]}>"
                dyn = native.kernels().hmm_fused_mlp_smem_bytes(int(gemm.group(1)))
            elif "topk_cosine" in mangled:
                name, dyn = "topk_cosine", topk_plan["smem_bytes"]
            else:
                name, dyn = (kind.group(1) if kind else mangled), 0
            out.append({
                "source": source, "kernel": name,
                "registers": int(used.group(1)) if used else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None,
                "static_smem": int(smem.group(1)) if smem else 0,
                "dynamic_smem": dyn,
                # ptxas's C7515: wgmma serialized (accumulators written between issue and wait)
                "wgmma_serialized_notes": sum(1 for ln in log.splitlines() if "C7515" in ln and mangled in ln),
            })
    return out


def set_fused_flags(fa, fm, on: bool) -> None:
    """HIPPOMM_FUSED_BLOCK / HIPPOMM_FLASH_BTHD as a user sets them, then the
    cached route policies re-read."""
    for flag in ("HIPPOMM_FUSED_BLOCK", "HIPPOMM_FLASH_BTHD"):
        if on:
            os.environ[flag] = "1"
        else:
            os.environ.pop(flag, None)
    for policy in (fa.flash_default, fa.bthd_default, fm.fused_mlp_default, fm.fused_block_default):
        policy.cache_clear()


_STORE_ROWS = weakref.WeakKeyDictionary()  # index -> {(event id, row in event): store row}


def compare_hits(index, query, got, want, what: str):
    """The device route's hits against the host route's over the same store:
    as many, and at every rank the device's similarity and the cosine of the
    row it returned there, recomputed in fp64 from the host store, both
    within 1e-5 of the host route's similarity at that rank. The two routes
    round each similarity differently, so rows closer than 1e-5 may swap
    ranks or trade the last place: a different (event id, time) at a rank
    passes only where the host's similarities there and at a neighbouring
    rank lie within 1e-5 (or at the last rank), and the recomputed cosine
    holds it to the host's value either way. Returns the largest gap and
    the number of near-tie ranks."""
    import numpy as np

    from hippomm_tpu_torch.utils.device import fetch

    rows = _STORE_ROWS.get(index)
    if rows is None:
        rows = _STORE_ROWS[index] = {(o, int(i)): r for r, (o, i) in enumerate(zip(index.owners, index.in_event_idx))}
    q = fetch(query, np.float64).reshape(-1)
    q = q / max(float(np.linalg.norm(q)), 1e-8)

    def show():
        return (f"device-route hits {[(h.event_id, h.time, h.similarity) for h in got]} != host-route "
                f"{[(h.event_id, h.time, h.similarity) for h in want]}")

    keys = [(h.event_id, h.index_in_event) for h in got]
    if len(got) != len(want) or len(set(keys)) != len(keys) or not all(k in rows for k in keys):
        fail(f"{what}: {show()}")
    w = [h.similarity for h in want]
    err, ties = 0.0, 0
    for j, (g, h) in enumerate(zip(got, want)):
        f = index._feats[rows[(g.event_id, g.index_in_event)]].astype(np.float64)
        cos = float(f @ q) / max(float(np.linalg.norm(f)), 1e-8)
        err = max(err, abs(g.similarity - w[j]), abs(cos - w[j]))
        if not err <= 1e-5:
            fail(f"{what}: rank {j}: similarity {g.similarity}, row cosine {cos}, host {w[j]}; {show()}")
        if (g.event_id, g.time) != (h.event_id, h.time):
            tie = (j == len(w) - 1 or abs(w[j + 1] - w[j]) < 1e-5 or (j > 0 and abs(w[j] - w[j - 1]) < 1e-5))
            if not tie:
                fail(f"{what}: rank {j} differs with no near tie; {show()}")
            ties += 1
    return err, ties


class QuerySpies:
    """What one question does on the card: text-tower forwards (their rows),
    Whisper encoder batches, device top-k rounds (their k), every search with
    its hits, and seconds per stage (each stage ends in a synchronize)."""

    def __init__(self):
        from hippomm_tpu_torch.core import ask_question as aq
        from hippomm_tpu_torch.models import foundation
        from hippomm_tpu_torch.models.imagebind import model as ib_model
        from hippomm_tpu_torch.models.whisper import transcribe as wh_transcribe
        from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex
        from hippomm_tpu_torch.utils import tokens

        self._saved = []
        self.reset()
        self.real_search = FeatureSearchIndex.search
        self.real_search_batch = FeatureSearchIndex.search_batch
        self._patch(aq, "_qa_system", self._timed("setup", aq._qa_system))
        # the first count_tokens imports `transformers` and looks for a local
        # GPT-2 tokenizer (local files only; chars/4 when there is none)
        self._patch(tokens, "_get_tokenizer", self._timed("token_counter", tokens._get_tokenizer))
        self._patch(ib_model, "text_forward", self._timed(
            "text_forward", ib_model.text_forward, lambda a, k, out: self.text_rows.append(a[1].numel())))
        self._patch(foundation.Whisper, "transcribe_batch",
                    self._timed("transcribe", foundation.Whisper.transcribe_batch))
        enc = wh_transcribe.encoder_forward
        self._patch(wh_transcribe, "encoder_forward",
                    lambda *a, **k: self.encoder_batches.append(1) or enc(*a, **k))
        # every search round, and the rounds that ran on the device
        for name, seen in (("_topk", "rounds"), ("_topk_device", "device_ks"),
                           ("_topk_batch", "batch_rounds"), ("_topk_batch_device", "device_batches")):
            fn = getattr(FeatureSearchIndex, name)
            self._patch(FeatureSearchIndex, name,
                        lambda idx, q, k, fn=fn, seen=seen: getattr(self, seen).append(k) or fn(idx, q, k))
        self._patch(FeatureSearchIndex, "search", self._timed(
            "search", self.real_search, lambda a, k, out: self.searches.append((a, k, out))))
        self._patch(FeatureSearchIndex, "search_batch", self._timed(
            "search_batch", self.real_search_batch, lambda a, k, out: self.batches.append((a, k, out))))

    def _patch(self, obj, name, new):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def _timed(self, stage, fn, record=None):
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.stages[stage] = self.stages.get(stage, 0.0) + time.perf_counter() - t0
            if record is not None:
                record(a, k, out)
            return out

        return run

    def reset(self):
        self.stages, self.text_rows, self.encoder_batches = {}, [], []
        self.rounds, self.device_ks, self.searches, self.batches = [], [], [], []
        self.batch_rounds, self.device_batches = [], []

    def restore(self):
        for obj, name, old in reversed(self._saved):
            setattr(obj, name, old)

    def host_route_agrees(self, what: str):
        """Every search of the question, again on the host route: the largest
        similarity gap and the near-tie ranks (compare_hits)."""
        import numpy as np

        err, ties = 0.0, 0
        os.environ["HIPPOMM_TOPK_ROUTE"] = "host"
        try:
            pairs = [(a[0], a[1], hits, self.real_search(*a, **k)) for a, k, hits in self.searches]
            for a, k, hits in self.batches:
                pairs += [(a[0], q, got, want) for q, got, want in
                          zip(np.atleast_2d(a[1]), hits, self.real_search_batch(*a, **k))]
            for index, query, got, want in pairs:
                e, t = compare_hits(index, query, got, want, what)
                err, ties = max(err, e), ties + t
        finally:
            os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
        return err, ties


def query_phase(qcfg, counters, fa, fm):
    """Questions through core/ask_question, each building its engine from
    the config as a user's call does; exact launch counts per question."""
    import gc

    import torch

    from hippomm_tpu_torch.core.ask_question import ask_question, ask_questions

    spies = QuerySpies()
    os.environ.pop("HIPPOMM_TOPK_ROUTE", None)  # the route a user's call takes
    runs, totals = {}, {name: 0 for name in counters}
    try:
        for name, fused, call, qtypes in (
            ("video", False, lambda: [ask_question(VIDEO_Q, qcfg)], ["VIDEO"]),
            ("sound", False, lambda: [ask_question(SOUND_Q, qcfg)], ["AUDIO"]),
            ("summary", False, lambda: [ask_question(SUMMARY_Q, qcfg)], ["SUMMARY"]),
            ("batch8", False, lambda: ask_questions(BATCH_QS, qcfg), ["VIDEO"] * len(BATCH_QS)),
            ("video_fused", True, lambda: [ask_question(VIDEO_Q, qcfg)], ["VIDEO"]),
        ):
            set_fused_flags(fa, fm, fused)
            gc.collect()
            torch.cuda.empty_cache()
            spies.reset()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            n_text, n_enc = len(spies.text_rows), len(spies.encoder_batches)
            n_k5 = sum(1 for k in spies.device_ks if k <= 128)
            expect = {
                "flash_mha": WHISPER_DEPTH * n_enc,
                "fused_mlp": (0 if fused else TEXT_DEPTH * n_text) + WHISPER_DEPTH * n_enc,
                "fused_ln_mlp_residual": TEXT_DEPTH * n_text if fused else 0,
                "flash_mha_bthd": 0,
                "top_k_cosine": n_k5,
            }
            stages = dict(spies.stages)
            stages["rest"] = wall - sum(stages.values())
            print(f"query {name}: wall {wall:.3f} s; text rows {spies.text_rows}, encoder batches "
                  f"{n_enc}, search rounds k {spies.rounds} (on the device {spies.device_ks}), batch "
                  f"rounds k {spies.batch_rounds}; launches {launches}, expected {expect}", flush=True)
            print(f"query stages {name}: " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
                  flush=True)
            if launches != expect:
                fail(f"query {name}: kernel launches {launches} != {expect}")
            if spies.device_ks != spies.rounds or spies.device_batches != spies.batch_rounds:
                fail(f"query {name}: search rounds {spies.rounds} / batches {spies.batch_rounds} did not "
                     f"all run on the device ({spies.device_ks} / {spies.device_batches})")
            if [r.question_type for r in results] != qtypes or not all(r.answer for r in results):
                fail(f"query {name}: results {[(r.question_type, r.answer) for r in results]}")
            if name == "batch8" and spies.text_rows != [77 * len(BATCH_QS)]:
                fail(f"query batch8: text forwards of {spies.text_rows} rows, not one of 616")
            if name in ("video", "sound", "video_fused") and (spies.text_rows != [77] or n_k5 < 1):
                fail(f"query {name}: text rows {spies.text_rows}, {n_k5} K5 rounds")
            if name == "sound" and n_enc < 1:
                fail("query sound: no Whisper re-transcription ran")
            if name == "summary" and not (results[0].used_direct_answer and sum(launches.values()) == 0):
                fail(f"query summary: not answered on the fast path: {launches}")
            rounds = {"search_rounds_k": list(spies.rounds), "device_topk_k": list(spies.device_ks),
                      "batch_rounds_k": list(spies.batch_rounds)}
            err, ties = spies.host_route_agrees(f"query {name}")
            print(f"query {name}: {len(spies.searches)} searches and {len(spies.batches)} batches "
                  f"agree with the host route (similarity gap {err:.3g}, {ties} near-tie ranks)",
                  flush=True)
            runs[name] = {"wall_s": wall, "stages_s": stages, "launches": launches,
                          "expected_launches": expect, "text_rows": spies.text_rows,
                          **rounds, "encoder_batches": n_enc,
                          "host_route_max_sim_gap": err, "host_route_near_ties": ties,
                          "results": [r.to_dict() for r in results]}
            if not fused:
                for k, v in launches.items():
                    totals[k] += v
    finally:
        spies.restore()
        set_fused_flags(fa, fm, False)
    for k in ("fused_mlp", "top_k_cosine", "flash_mha"):
        if totals[k] == 0:
            fail(f"query path: {k} was never launched")
    return {"runs": runs, "launches": totals}


def _rss_kib():
    """This process's resident set in KiB (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1])
    return None


class _PeakRss:
    """The largest VmRSS seen by a thread sampling every 5 ms while the
    block runs (the kernel's own peak counter is the process lifetime's)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = _rss_kib() or 0, threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, _rss_kib() or 0)

        self._t = threading.Thread(target=sample, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, _rss_kib() or 0)


def _http(port: int, path: str, payload=None):
    """(status, JSON body) of one request to the local server; an HTTP error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _Timed:
    """Wrap module attributes to add each call's seconds to `self.s[name]`."""

    def __init__(self):
        self.s, self._saved = {}, []

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0

        self._saved.append((obj, attr, fn))
        setattr(obj, attr, run)

    def restore(self):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)


def serve_phase(counters, ib_depths):
    """9. the QA server (core/serve) started from an ImageBind-Huge
    checkpoint file, driven over HTTP (see the module doc)."""
    import gc
    import threading

    import numpy as np
    import torch

    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core import serve
    from hippomm_tpu_torch.media import io as mio
    from hippomm_tpu_torch.media.synth import SynthSpec, generate
    from hippomm_tpu_torch.memory import engine
    from hippomm_tpu_torch.models import foundation
    from hippomm_tpu_torch.models.imagebind import convert as ib_convert
    from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
    from hippomm_tpu_torch.models.imagebind.manifest import random_state_dict
    from hippomm_tpu_torch.models.imagebind.model import huge_config
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem

    vis_depth, aud_depth = ib_depths
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as work:
        # 1. a seeded full-width checkpoint, fp32 .pth, and towers carried
        # from the same numpy weights to hold the loaded ones against
        t0 = time.perf_counter()
        sd = random_state_dict(huge_config(), seed=9)
        out["checkpoint_gen_s"] = time.perf_counter() - t0
        ckpt = os.path.join(work, "imagebind_huge.pth")
        t0 = time.perf_counter()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
        out["checkpoint_write_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(ckpt)
        out["checkpoint_params"] = int(sum(v.size for v in sd.values()))
        ref = foundation.ImageBind(device=dev, params=params_from_jax(
            ib_convert.convert_state_dict(sd, huge_config()), huge_config(), dev))
        del sd
        gc.collect()
        print(f"serve: checkpoint of {out['checkpoint_params']} fp32 parameters, "
              f"{out['checkpoint_bytes'] / 1e9:.3f} GB, generated in {out['checkpoint_gen_s']:.1f} s, "
              f"written in {out['checkpoint_write_s']:.1f} s", flush=True)

        store = os.path.join(work, "store")
        cfg = Config()
        cfg.api.mode = "stub"
        cfg.models.imagebind_variant = "huge"
        cfg.models.imagebind_path = ckpt
        cfg.models.whisper_variant = "distil-large-v3"
        cfg.models.whisper_random_init = True
        cfg.processing.fast_path_confidence = 2.0
        cfg.storage.base_dir = store

        # 2. the server's engine on the card, from the file
        rss_before = _rss_kib()
        timed = _Timed()
        timed.wrap(ib_convert, "load_state_dict", "read")
        timed.wrap(ib_convert, "convert_state_dict", "convert")
        timed.wrap(ib_convert, "params_from_jax", "carry")
        timed.wrap(engine.HippocampalMemory, "__init__", "engine")
        try:
            with _PeakRss() as rss:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                service = serve.QAService(cfg)
                torch.cuda.synchronize()
                startup = time.perf_counter() - t0
        finally:
            timed.restore()
        rss_after, peak = _rss_kib(), rss.peak
        ib = service.memory.imagebind
        if (ib.cfg.vision.width, ib.cfg.vision.depth) != (1280, vis_depth) or ib.device.type != "cuda":
            fail("serve: the service did not build ImageBind-Huge on the card")
        frames = generate(SynthSpec(duration=4.0, fps=1.0, width=640, height=360, seed=31)).frames
        agree = {"vision": float(np.abs(ib.encode_vision(frames) - ref.encode_vision(frames)).max()),
                 "text": float(np.abs(ib.encode_text(BATCH_QS[:2]) - ref.encode_text(BATCH_QS[:2])).max())}
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        out["startup"] = {"total_s": startup, "read_s": timed.s.get("read"),
                          "convert_s": timed.s.get("convert"), "carry_s": timed.s.get("carry"),
                          "engine_s": timed.s.get("engine"), "rss_before_kib": rss_before, "rss_after_kib": rss_after,
                          "peak_rss_kib": peak}
        print(f"serve startup: {startup:.2f} s (engine {timed.s.get('engine', 0):.2f} s: read "
              f"{timed.s.get('read', 0):.2f} s (memory-mapped), convert {timed.s.get('convert', 0):.2f} s, "
              f"carry to the card {timed.s.get('carry', 0):.2f} s; no warmup: the store is empty); RSS "
              f"{rss_before / 2**20:.2f} -> {rss_after / 2**20:.2f} GiB, peak {peak / 2**20:.2f} GiB during "
              f"the startup (sampled every 5 ms)", flush=True)
        print(f"serve: loaded towers vs towers carried from the same weights: max abs {agree}", flush=True)
        if agree != {"vision": 0.0, "text": 0.0}:
            fail(f"serve: the checkpoint's towers differ from the same weights carried directly: {agree}")
        out["loaded_vs_carried_max_abs"] = agree

        server = serve.make_server(service, port=0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            out.update(_serve_requests(service, port, counters, work, vis_depth, aud_depth, mio))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if thread.is_alive():
            fail("serve: the server thread did not stop")

        # a restart over the store the requests built, the checkpoint's pages
        # first dropped from the page cache: a read from the disk, and warmup
        del service, ib
        gc.collect()
        torch.cuda.empty_cache()
        os.sync()
        with open(ckpt, "rb") as f:
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
        timed = _Timed()
        timed.wrap(ib_convert, "load_state_dict", "read")
        timed.wrap(ib_convert, "params_from_jax", "carry")
        timed.wrap(engine.HippocampalMemory, "__init__", "engine")
        timed.wrap(QARecallSystem, "answer_question", "warmup")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = serve.QAService(cfg)
            torch.cuda.synchronize()
            restart = time.perf_counter() - t0
        finally:
            timed.restore()
        n_events = len(again.memory.long_term_store)
        del again
        gc.collect()
        torch.cuda.empty_cache()
        out["restart"] = {"total_s": restart, "events": n_events, **{f"{k}_s": v for k, v in timed.s.items()}}
        rate = out["checkpoint_bytes"] / (timed.s.get("read", 0) + timed.s.get("carry", 0)) / 1e9
        print(f"serve restart over {n_events} events, the checkpoint's pages dropped from the page cache: "
              f"{restart:.2f} s (engine {timed.s.get('engine', 0):.2f} s: read {timed.s.get('read', 0):.2f} s, "
              f"carry {timed.s.get('carry', 0):.2f} s, {rate:.2f} GB/s from the file to the card; warmup "
              f"{timed.s.get('warmup', 0):.2f} s)", flush=True)
        if "warmup" not in timed.s:
            fail("serve: the restart over a non-empty store ran no warmup question")
    lat = out["latency_ms"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(f"serve summary ({out['card']}): startup {out['startup']['total_s']:.2f} s, restart with warmup "
          f"{out['restart']['total_s']:.2f} s; /ask p50 {lat['ask']['p50']} ms, p95 {lat['ask']['p95']} ms; "
          f"/ask_batch {lat['ask_batch_per_q']['p50']} ms per question; /ingest folder "
          f"{out['ingest']['folder']['wall_s']:.2f} s (realtime multiple "
          f"{out['ingest']['folder']['realtime_multiple']:.1f}), single file "
          f"{out['ingest']['single']['wall_s']:.2f} s", flush=True)
    return out


def _serve_requests(service, port, counters, work, vis_depth, aud_depth, mio):
    """The HTTP requests of phase 9 against a running server."""
    import concurrent.futures

    import torch

    from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video

    mem = service.memory
    out = {}
    folder = os.path.join(work, "videos")
    os.makedirs(folder)
    ext = ".mp4" if mio.libav_available() else ".y4m"
    if ext == ".y4m":
        print("serve: the libav shim did not build or load on this machine (the warning above says why): "
              "clips written as .y4m with sibling 16 kHz .wav files", flush=True)
    else:
        print("serve: libav shim built and loaded: clips written as .mp4 with the audio track embedded",
              flush=True)
    specs = {"a": SynthSpec(duration=40.0, fps=4.0, width=640, height=360, scene_changes=(15.0, 28.0),
                            silence_regions=((19.5, 20.5),), seed=41),
             "b": SynthSpec(duration=30.0, fps=4.0, width=640, height=360, scene_changes=(12.0,), seed=42),
             "c": SynthSpec(duration=20.0, fps=4.0, width=640, height=360, scene_changes=(8.0,), seed=43)}

    def write(vid, where):
        path = os.path.join(where, vid + ext)
        wav = None if ext == ".mp4" else os.path.join(where, vid + ".wav")
        write_synthetic_video(path, specs[vid], audio_path=wav)
        return path

    for vid in ("a", "b"):
        write(vid, folder)
    single = write("c", work)
    out["container"] = ext

    # /ingest of the folder, then of one file: exact K1/K2 counts
    ingests = {}
    for name, path, vids in (("folder", folder, ("a", "b")), ("single", single, ("c",))):
        spies = CliSpies()
        try:
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status, stats = _http(port, "/ingest", {"path": path})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            spies.restore()
        if status != 200 or stats.get("processed") != len(vids) or stats.get("failed") != 0:
            fail(f"serve /ingest {name}: status {status}, {stats}")
        videos, expect = ingest_blocks(spies, mem, vids, vis_depth, aud_depth)
        expect["top_k_cosine"] = 0
        print(f"serve /ingest {name}: {status}, {stats.get('processed')} processed in {wall:.2f} s "
              f"({videos}); launches {launches}, expected {expect}", flush=True)
        if launches != expect:
            fail(f"serve /ingest {name}: kernel launches {launches} != {expect}")
        media = sum(specs[v].duration for v in vids)
        ingests[name] = {"status": status, "wall_s": wall, "media_s": media, "realtime_multiple": media / wall,
                         "stats": stats, "videos": videos, "launches": launches, "expected_launches": expect}
    out["ingest"] = ingests
    status, health = _http(port, "/healthz")
    status_ev, events = _http(port, "/events")
    if (status, status_ev, health.get("events"), len(events.get("events", []))) != (200, 200, 3, 3):
        fail(f"serve: /healthz {status} {health}, /events {status_ev} {events}")
    print(f"serve: /healthz {health['events']} events, {health['videos']} videos; /events "
          f"{events['events']}", flush=True)

    # /ask and /ask_batch: exact K2 / K5 counts, every search on the card
    # and its hits against the host route
    spies = QuerySpies()
    os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
    asks = {}
    try:
        for name, path, payload, qtypes in (
            ("video", "/ask", {"question": VIDEO_Q}, ["VIDEO"]),
            ("sound", "/ask", {"question": SOUND_Q}, ["AUDIO"]),
            ("summary", "/ask", {"question": SUMMARY_Q}, ["SUMMARY"]),
            ("batch8", "/ask_batch", {"questions": BATCH_QS}, ["VIDEO"] * len(BATCH_QS)),
        ):
            spies.reset()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status, body = _http(port, path, payload)
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            results = body.get("results", [body]) if status == 200 else []
            n_text, n_enc = len(spies.text_rows), len(spies.encoder_batches)
            n_k5 = sum(1 for k in spies.device_ks if k <= 128)
            expect = {"flash_mha": WHISPER_DEPTH * n_enc,
                      "fused_mlp": TEXT_DEPTH * n_text + WHISPER_DEPTH * n_enc,
                      "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0, "top_k_cosine": n_k5}
            print(f"serve {path} {name}: {status} in {wall * 1e3:.1f} ms; text rows {spies.text_rows}, "
                  f"encoder batches {n_enc}, search rounds k {spies.rounds} (on the device "
                  f"{spies.device_ks}), batch rounds k {spies.batch_rounds}; launches {launches}, "
                  f"expected {expect}", flush=True)
            if status != 200:
                fail(f"serve {path} {name}: status {status}: {body}")
            if launches != expect:
                fail(f"serve {path} {name}: kernel launches {launches} != {expect}")
            if spies.device_ks != spies.rounds or spies.device_batches != spies.batch_rounds:
                fail(f"serve {name}: search rounds {spies.rounds} / batches {spies.batch_rounds} did not "
                     f"all run on the device ({spies.device_ks} / {spies.device_batches})")
            if [r["question_type"] for r in results] != qtypes or not all(r["answer"] for r in results):
                fail(f"serve {name}: results {[(r['question_type'], r['answer']) for r in results]}")
            if name == "batch8" and spies.text_rows != [77 * len(BATCH_QS)]:
                fail(f"serve batch8: text forwards of {spies.text_rows} rows, not one of 616")
            if name in ("video", "sound") and (spies.text_rows != [77] or n_k5 < 1):
                fail(f"serve {name}: text rows {spies.text_rows}, {n_k5} K5 rounds")
            if name == "sound" and n_enc < 1:
                fail("serve sound: no Whisper re-transcription ran")
            if name == "summary" and not (results[0]["used_direct_answer"] and sum(launches.values()) == 0):
                fail(f"serve summary: not answered on the fast path: {launches}")
            stages = dict(spies.stages)
            stages["rest"] = wall - sum(stages.values())  # recall, captions, HTTP
            print(f"serve stages {name}: " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
                  flush=True)
            err, ties = spies.host_route_agrees(f"serve {name}")
            print(f"serve {name}: {len(spies.searches)} searches and {len(spies.batches)} batches agree "
                  f"with the host route (similarity gap {err:.3g}, {ties} near-tie ranks)", flush=True)
            asks[name] = {"wall_s": wall, "launches": launches, "expected_launches": expect,
                          "text_rows": list(spies.text_rows), "search_rounds_k": list(spies.rounds),
                          "encoder_batches": n_enc, "host_route_max_sim_gap": err,
                          "host_route_near_ties": ties, "stages_s": stages}
    finally:
        spies.restore()
    out["ask"] = asks

    # 4 concurrent /ask requests, each on its own handler thread
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(_http, port, "/ask", {"question": q}) for q in BATCH_QS[:4]]
        codes = [f.result()[0] for f in futs]
    status, health = _http(port, "/healthz")
    lat = health.get("latency_ms", {})
    ask = lat.get("ask", {})
    print(f"serve: 4 concurrent /ask {codes}; latency_ms {lat}", flush=True)
    if codes != [200] * 4 or ask.get("count", 0) < 7 or not ask.get("p95", -1) >= ask.get("p50", 0) > 0:
        fail(f"serve: concurrent asks {codes}, latency histogram {lat}")
    out["latency_ms"] = lat

    # a corrupt upload: 500, and nothing of it left in the engine
    bad = os.path.join(work, "corrupt.mp4")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 4096)
    status, body = _http(port, "/ingest", {"path": bad})
    residue = [name for name, d in (("_asr_futures", mem._asr_futures), ("_full_audio", mem._full_audio),
                                    ("short_term_buffer", mem.short_term_buffer),
                                    ("consolidated", mem.consolidated)) if "corrupt" in d]
    print(f"serve: corrupt /ingest {status} {body}; residue {residue}", flush=True)
    if status != 500 or residue:
        fail(f"serve: corrupt upload gave {status} {body}, residue {residue}")
    out["corrupt_ingest"] = {"status": status, "error": body.get("error")}
    return out


def search_phase(ttk):
    """A FeatureSearchIndex of 200 000 seeded unit rows × 1024 (100 events
    of 2000 1 fps keyframes, about 55 h): 64 single-query searches on the
    route a user's call takes (the device: K5), one search_batch of 64, and
    4 queries on the host route, timed and held against both."""
    import numpy as np
    import torch

    from hippomm_tpu_torch.memory.schema import ThetaEvent
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex

    n_events, rows, d = 100, 2000, 1024
    gen = torch.Generator(device="cuda").manual_seed(7)
    feats = torch.randn((n_events * rows, d), generator=gen, device="cuda")
    feats = (feats / feats.norm(dim=1, keepdim=True)).cpu().numpy()
    t0 = time.perf_counter()
    events = [ThetaEvent(video_id=f"v{e:03d}", features={"vision": feats[e * rows:(e + 1) * rows]},
                         feature_times={"vision": [float(t) for t in range(rows)]},
                         start_time=0.0, end_time=float(rows)) for e in range(n_events)]
    index = FeatureSearchIndex.build(events, "vision")
    queries = torch.randn((64, d), generator=gen, device="cuda")
    os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
    try:
        index.search(queries[0])  # uploads and normalizes the store once
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        ttk.top_k_cosine_kernel.launches = 0
        per_query, hits = [], []
        for i in range(64):
            t1 = time.perf_counter()
            hits.append(index.search(queries[i]))
            per_query.append((time.perf_counter() - t1) * 1e3)
        launches = ttk.top_k_cosine_kernel.launches
        if launches < 64:
            fail(f"search: {launches} K5 launches for 64 device-route searches")
        host_q = queries.cpu().numpy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = index.search_batch(host_q)
        batch_ms = (time.perf_counter() - t1) * 1e3
        os.environ["HIPPOMM_TOPK_ROUTE"] = "host"
        err, ties, host_ms = 0.0, 0, []
        for i in range(4):
            t1 = time.perf_counter()
            want = index.search(host_q[i])
            host_ms.append((time.perf_counter() - t1) * 1e3)
            for got, what in ((hits[i], "search"), (batch[i], "search_batch")):
                e, t = compare_hits(index, host_q[i], got, want, f"{what} query {i}")
                err, ties = max(err, e), ties + t
    finally:
        os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
    out = {"rows": len(index), "events": n_events, "setup_s": setup, "single_ms": per_query,
           "single_ms_mean": float(np.mean(per_query)), "single_ms_median": float(np.median(per_query)),
           "batch64_ms": batch_ms, "batch_ms_per_query": batch_ms / 64, "k5_launches": launches,
           "host_route_ms": host_ms,
           "host_route_max_sim_gap": err, "host_route_near_ties": ties}
    print(f"search: {len(index)} rows in {n_events} events; single query {out['single_ms_mean']:.3f} ms "
          f"mean, {out['single_ms_median']:.3f} ms median ({launches} K5 launches for 64); batch of 64 "
          f"{batch_ms:.3f} ms ({batch_ms / 64:.3f} ms/query); host route {host_ms} ms for 4 queries, "
          f"whose hits the device routes' agree with (similarity gap {err:.3g}, {ties} near-tie "
          f"ranks); set-up {setup:.1f} s", flush=True)
    return out


class CliSpies:
    """What the ingest CLI does on the card: every key-frame scanner's fed
    luma, times and mask handles, the seconds of each mask read (and how
    many blocks it read), each video's extraction result (kept frames and
    vision stream), the engines it builds, and per-video wall from the
    log of process_video_folder."""

    def __init__(self):
        import logging

        import numpy as np

        from hippomm_tpu_torch.core import batch_process as bp
        from hippomm_tpu_torch.memory import engine
        from hippomm_tpu_torch.ops import keyframe as kf

        self.scans, self.reads, self.extracted, self.engines, self.walls = {}, [], {}, [], {}
        self._saved = []
        real_feed, real_read, real_extract = kf.KeyframeScanner.feed, kf.KeyframeScanner._read, \
            bp.extract_frames_from_video
        real_init = engine.HippocampalMemory.__init__

        def feed(sc, grays, times):
            h = real_feed(sc, grays, times)
            # the scanner is kept alive with its record, so no id is reused
            self.scans.setdefault(id(sc), (sc, []))[1].append((np.array(grays), list(times), h))
            return h

        def read(sc, masks):
            import time as _t

            t0 = _t.perf_counter()
            out = real_read(sc, masks)
            self.reads.append((len(masks), _t.perf_counter() - t0))
            return out

        def extract(video_path, *a, **k):
            meta = real_extract(video_path, *a, **k)
            self.extracted[os.path.splitext(os.path.basename(video_path))[0]] = meta
            return meta

        def init(mem, *a, **k):
            real_init(mem, *a, **k)
            self.engines.append(mem)

        for obj, name, new in ((kf.KeyframeScanner, "feed", feed), (kf.KeyframeScanner, "_read", read),
                               (bp, "extract_frames_from_video", extract),
                               (engine.HippocampalMemory, "__init__", init)):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)
        spies = self

        class _Walls(logging.Handler):
            def emit(self, record):
                if record.getMessage().endswith("s") and " done in " in record.getMessage():
                    vid, sec = record.getMessage().rsplit(" done in ", 1)
                    spies.walls[vid] = float(sec[:-1])

        self._handler = _Walls()
        logging.getLogger(bp.__name__).addHandler(self._handler)
        logging.getLogger(bp.__name__).setLevel(logging.INFO)

    def restore(self):
        import logging

        from hippomm_tpu_torch.core import batch_process as bp

        for obj, name, old in reversed(self._saved):
            setattr(obj, name, old)
        logging.getLogger(bp.__name__).removeHandler(self._handler)


def ingest_blocks(spies, mem, vids, vis_depth: int, aud_depth: int):
    """Each ingested video's encoder blocks, from what the CLI spies saw:
    vision through the stream's 32-wide chunks (ceil(fed / 32) batches of
    vis_depth blocks), audio segments in 32-wide chunks of aud_depth blocks,
    and one Whisper encoder batch of 32 blocks per 32 ASR chunks of 30 s.
    Every block is one K1 and one K2 launch in the default configuration.
    Returns the per-video record and the expected launch counts."""
    import numpy as np

    videos, total = {}, 0
    for vid in vids:
        meta = spies.extracted[vid]
        stream = meta["vision_stream"]
        base = getattr(stream, "_stream", stream)
        stms = mem.store.load_checkpoint(vid)
        n_aud = sum(1 for s in stms if "audio" in s.features)
        npy = os.path.join(mem.store.audio_dir, vid, "audio.npy")
        n_pcm = len(np.load(npy, mmap_mode="r")) if os.path.exists(npy) else 0
        enc_batches = math.ceil(math.ceil(n_pcm / (30 * 16000)) / 32)
        blocks = (math.ceil(base.frames_fed / 32) * vis_depth + math.ceil(n_aud / 32) * aud_depth
                  + enc_batches * WHISPER_DEPTH)
        total += blocks
        videos[vid] = {"route": "keyframe_feed" if base is stream else "encode_all_candidates",
                       "fed": base.frames_fed, "keyframes": len(meta["frame_times"]),
                       "audio_segments": n_aud, "encoder_batches": enc_batches, "blocks": blocks,
                       "wall_s": spies.walls.get(vid)}
    return videos, {"flash_mha": total, "fused_mlp": total, "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}


def scan_agrees_with_cpu(block, fed, what: str, thr: float = 0.3, gap: float = 1.0):
    """The card's key-frame mask of one video against the port's CPU scan of
    the same luma. The only difference let through is at a candidate whose
    diff or cumulative diff lies within 1e-4 of the threshold (printed; the
    walks part there, so the rest is not compared). Returns the number of
    candidates and of key frames."""
    import numpy as np
    import torch

    from hippomm_tpu_torch.ops.keyframe import select_keyframes_device
    from hippomm_tpu_torch.ops.ssim import ssim_pairs

    grays = np.concatenate([g for g, _, _ in fed])
    times = [t for _, ts, _ in fed for t in ts]
    card = np.concatenate([h.get() for _, _, h in fed]).astype(bool)
    cpu = np.zeros(len(grays), bool)
    cpu[select_keyframes_device(grays, times, thr, gap, block=block, device="cpu")] = True
    diff_at = np.nonzero(card != cpu)[0]
    if len(diff_at):
        j = int(diff_at[0])
        ref, cum, tlast = None, 0.0, -1e9
        for i in range(j):  # the walks agree up to j: replay it for j's scores
            if card[i]:
                ref, cum, tlast = i, 0.0, times[i]
            elif ref is not None and np.float32(times[i]) - np.float32(tlast) >= gap:
                cum += 1.0 - ssim_pairs(torch.from_numpy(grays[ref][None]), torch.from_numpy(grays[i][None])).item()
        d = 1.0 - ssim_pairs(torch.from_numpy(grays[ref][None]), torch.from_numpy(grays[j][None])).item()
        margin = min(abs(d - thr), abs(cum + d - thr))
        print(f"cli {what}: candidate {j} (t {times[j]} s) card {card[j]} cpu {cpu[j]}: diff {d:.6f}, "
              f"cumulative {cum + d:.6f}, {margin:.2e} from the threshold {thr}", flush=True)
        if margin > 1e-4:
            fail(f"cli {what}: the card's key-frame mask differs from the CPU scan at candidate {j}")
    return len(grays), int(card.sum())


def cli_phase(counters, ib_depths):
    """8. the ingest CLI on a folder of two clips (see the module doc)."""
    import gc

    import numpy as np
    import torch
    import yaml

    from hippomm_tpu_torch.core import batch_process as bp
    from hippomm_tpu_torch.media import io as mio
    from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video

    vis_depth, aud_depth = ib_depths
    out = {}
    with tempfile.TemporaryDirectory() as work:
        folder, store = os.path.join(work, "videos"), os.path.join(work, "store")
        os.makedirs(folder)
        t0 = time.perf_counter()
        write_synthetic_video(os.path.join(folder, "long.y4m"), SynthSpec(
            duration=120.0, fps=4.0, width=640, height=360, scene_changes=(30.0, 70.0, 100.0),
            silence_regions=((59.5, 60.5),), seed=21), audio_path=os.path.join(folder, "long.wav"))
        short = "short.avi" if mio.native_available() else "short.y4m"
        if short == "short.y4m":
            print("cli: the media shim did not build or load on this machine (the warning above says "
                  "why): short clip written as .y4m, JPEG through PIL", flush=True)
        else:
            print("cli: media shim built and loaded (libjpeg): short clip written as MJPEG .avi",
                  flush=True)
        write_synthetic_video(os.path.join(folder, short), SynthSpec(
            duration=30.0, fps=4.0, width=640, height=360, scene_changes=(12.0,), seed=22),
            audio_path=os.path.join(folder, "short.wav"))
        out["setup_s"] = time.perf_counter() - t0
        out["short_container"] = short
        cfg_path = os.path.join(work, "config.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"api": {"mode": "stub"}, "models": {
                "imagebind_variant": "huge", "whisper_variant": "distil-large-v3",
                "whisper_random_init": True}}, f)
        argv = ["--path", folder, "--memory_store", store, "--config", cfg_path]

        spies = CliSpies()
        try:
            gc.collect()
            torch.cuda.empty_cache()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = bp.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            spies.restore()
        if (stats["processed"], stats["failed"], stats["skipped"]) != (2, 0, 0):
            fail(f"cli: processed {stats['processed']}, failed {stats['failed']} "
                 f"({stats['errors']}), skipped {stats['skipped']}")
        (mem,) = spies.engines
        ib = mem.imagebind
        if (ib.cfg.vision.width, ib.cfg.vision.depth) != (1280, vis_depth) or mem.whisper.cfg.d_model != 1280:
            fail("cli: main did not build ImageBind-Huge and Whisper distil-large-v3")

        # exact launch counts: vision through the stream's 32-wide chunks
        videos, expect = ingest_blocks(spies, mem, ("long", "short"), vis_depth, aud_depth)
        print(f"cli: {stats['processed']} videos in {wall:.2f} s ({videos}); launches {launches}, "
              f"expected {expect}", flush=True)
        if launches != expect:
            fail(f"cli: kernel launches {launches} != {expect}")
        if [videos[v]["route"] for v in ("long", "short")] != ["keyframe_feed", "encode_all_candidates"]:
            fail(f"cli: vision-stream routes {videos}")

        # one event per video, well-formed features
        events = {ev.video_id: ev for ev in mem.store.load_all_events()}
        if sorted(events) != ["long", "short"]:
            fail(f"cli: events {sorted(events)}")
        for ev in events.values():
            vis, aud = ev.features.get("vision"), ev.features.get("audio")
            if vis is None or aud is None or vis.shape[1] != 1024 or aud.shape[1] != 1024 \
                    or not (np.isfinite(vis).all() and np.isfinite(aud).all()) \
                    or np.abs(np.linalg.norm(vis, axis=1) - 1.0).max() > 1e-3 \
                    or not (0 < np.linalg.norm(aud, axis=1)).all() \
                    or not (np.linalg.norm(aud, axis=1) <= 20.0 + 1e-3).all():
                fail(f"cli: event {ev.video_id} features malformed")

        # the card's masks against the CPU scan of the same luma
        scans = list(spies.scans.values())
        if len(scans) != 2:
            fail(f"cli: {len(scans)} key-frame scans for two videos")
        for vid, (sc, fed) in zip(("long", "short"), scans):
            n_cand, n_key = scan_agrees_with_cpu(sc.block, fed, vid)
            videos[vid].update(candidates=n_cand, scan_blocks=len(fed))
            if n_key != videos[vid]["keyframes"]:
                fail(f"cli {vid}: {n_key} key frames in the masks, {videos[vid]['keyframes']} extracted")
        print(f"cli: card key-frame masks agree with the CPU scan "
              f"({ {v: videos[v]['candidates'] for v in videos} } candidates)", flush=True)

        # the scan alone, warm, on long.y4m's luma: host seconds a call
        # (launches and the one mask read) and its CUDA kernels per candidate
        from hippomm_tpu_torch.ops.keyframe import select_keyframes_device

        lg = np.concatenate([g for g, _, _ in scans[0][1]])
        lt = [t for _, ts, _ in scans[0][1] for t in ts]
        scan = lambda: select_keyframes_device(lg, lt, 0.3, 1.0, device=mem.device)  # noqa: E731
        scan()
        t0 = time.perf_counter()
        for _ in range(3):
            scan()
        scan_s = (time.perf_counter() - t0) / 3
        scan_us, scan_kernels = profile_kernels([scan], turns=1)
        per_cand = None if scan_kernels is None else scan_kernels / len(lg)
        scan_report = {"candidates": len(lg), "host_s": scan_s, "kernels_per_candidate": per_cand,
                       "device_us": None if scan_us is None else sum(scan_us.values())}
        print(f"cli scan: {len(lg)} candidates in {scan_s * 1e3:.1f} ms warm ("
              f"{scan_s * 1e6 / len(lg):.0f} µs a candidate), {per_cand} CUDA kernels a candidate, "
              f"{scan_report['device_us']} µs on the device", flush=True)

        # the stream's features against a one-shot encode of the same frames
        agree = {}
        for vid in ("long", "short"):
            meta = spies.extracted[vid]
            got = torch.from_numpy(meta["vision_stream"].result())
            want = torch.from_numpy(ib.encode_vision(meta["frames_rgb"]))
            err = (got - want).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
            agree[vid] = {"max_abs_err": err, "min_cosine": cos}
            print(f"cli {vid}: stream features vs encode_vision: max abs {err:.3g}, min cosine {cos:.6f}",
                  flush=True)
            if not (math.isfinite(err) and err <= 2e-2 and cos >= 0.999):
                fail(f"cli {vid}: stream features disagree with encode_vision: {err}, cos {cos}")
        timers = stats["engine"]["timers"]
        waits = [round(sec / n, 6) for n, sec in spies.reads]
        del mem, ib, spies
        gc.collect()
        torch.cuda.empty_cache()

        again = bp.main(argv)
        if (again["skipped"], again["processed"]) != (2, 0):
            fail(f"cli: the second run did not skip both videos: {again}")

        # the chunked streaming path on long.y4m under a new id, its own engine
        t0 = time.perf_counter()
        res = bp.process_single_video_streaming(
            os.path.join(folder, "long.y4m"), store, video_id="long_streamed", chunk_seconds=60.0,
            config=bp.load_config(cfg_path))
        torch.cuda.synchronize()
        stream_wall = time.perf_counter() - t0
        with open(os.path.join(store, "frames", "long", "metadata.yaml")) as f:
            whole = yaml.safe_load(f)["frame_times"]
        if res["frames"]["frame_times"] != whole:
            fail(f"cli: streaming key frames {res['frames']['frame_times']} != whole-video {whole}")
        from hippomm_tpu_torch.memory.store import MemoryStore

        if len(MemoryStore(store).events_for_video("long_streamed")) != 1:
            fail("cli: the streaming path did not write one event")
        print(f"cli streaming: {res['frames']['streamed_chunks']} chunks, the whole-video pass's "
              f"{len(whole)} key frames, one event, {stream_wall:.2f} s", flush=True)

    extract = {k: v for k, v in timers.items() if k.startswith("extract_")}
    engine_stages = {k: v for k, v in timers.items() if not k.startswith("extract_")}
    print(f"cli: per-video wall {({v: videos[v]['wall_s'] for v in videos})} s; realtime multiple "
          f"{stats['realtime_multiple']:.3f} ({stats['media_seconds']} s of media in "
          f"{stats['wall_seconds']:.3f} s)", flush=True)
    print("cli extract stages: " + json.dumps(extract), flush=True)
    print("cli engine stages: " + json.dumps(engine_stages), flush=True)
    print(f"cli mask reads: {len(waits)}, seconds per block read {waits}", flush=True)
    out.update(wall_s=wall, stats={k: v for k, v in stats.items() if k != "engine"}, videos=videos,
               launches=launches, expected_launches=expect, stream_vs_encode=agree, stages=timers,
               mask_read_s_per_block=waits, scan=scan_report, second_run=again["skipped"],
               streaming={"chunks": res["frames"]["streamed_chunks"], "wall_s": stream_wall,
                          "keyframes": len(whole)})
    return out


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
    from hippomm_tpu_torch.ops import topk as ttk
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
        # ... and the text tower: one question (77 rows), a batch of 8 (616)
        "fused_mlp": [check_mlp_kernel(fm, s, gen, False) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120), (77, 1024, 4096),
            (616, 1024, 4096))],
        "fused_ln_mlp_residual": [check_mlp_kernel(fm, s, gen, True) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (77, 1024, 4096), (616, 1024, 4096))],
        "flash_mha_bthd": [check_attention_bthd(fa, (32, 257, 16, 80), gen)],
        # the JAX package's store scale, search's first round, and 1e6 rows
        # at the kernel's k limit; then an ascending-sorted 2e5 store
        # (reported: the filter's worst case)
        "top_k_cosine": [check_topk(ttk, s, gen) for s in (
            (200_000, 1024, 20), (200_000, 1024, 40), (1_000_000, 1024, 128))]
        + [check_topk(ttk, (200_000, 1024, 20), gen, ascending=True)],
    }
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            r.setdefault("pct_of_bound", 100.0 * r["bound_ms"] / r["ms"])
            sets = f"{r['operand_sets']} rotating operand sets, " if "operand_sets" in r else ""
            extra = (f"; {r['kernels_per_call']} CUDA kernels per call, plan {r['plan']}, "
                     f"{sets}device µs per call "
                     f"{ {k: round(v, 2) for k, v in (r['device_us'] or {}).items()} }, "
                     f"host µs per call {r['host_us']:.1f}"
                     if "plan" in r else "")
            print(f"{name} {r['shape']}{' ascending' if r.get('ascending') else ''}: "
                  f"err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms "
                  f"plain {r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['pct_of_bound']:.1f} % of "
                  f"bound{extra}", flush=True)
    report["kernel_build"] = build_report(_native, rows["top_k_cosine"][0]["plan"])
    for k in report["kernel_build"]:
        print(f"build {k['source']} {k['kernel']}: {k['registers']} registers, {k['spill_stores']} / "
              f"{k['spill_loads']} bytes spill stores / loads, {k['static_smem']} bytes static and "
              f"{k['dynamic_smem']} bytes dynamic shared memory, {k['wgmma_serialized_notes']} ptxas "
              f"notes of serialized wgmma", flush=True)

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
        # the text tower on the 8 questions of the query phase's batch, its
        # output divided by exp(logit_scale) back to unit rows
        tokens = torch.from_numpy(ib.tokenizer(BATCH_QS)).cuda()
        text_scale = math.exp(ib.params["text"]["logit_scale"].item())
        with torch.no_grad():
            x = normalize_nchw(crops)
            mel = wt.mel(pcm[None])[:, :, : 2 * wcfg.max_source_positions]
            fast = {"vision": ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype),
                    "whisper_encoder": wh_model.encoder_forward(wt.params, mel, wcfg, wt.dtype)[0]}
            # the text tower's kernel launches: one K2 (K3 when fused) per block
            k2 = fm.fused_mlp.launches
            fast["text"] = ib_model.text_forward(ib.params, tokens, ib.cfg, ib.dtype) / text_scale
            k2 = fm.fused_mlp.launches - k2
            set_fused_flags(fa, fm, True)
            fast["vision_fused"] = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
            k3 = fm.fused_ln_mlp_residual.launches
            fast["text_fused"] = ib_model.text_forward(ib.params, tokens, ib.cfg, ib.dtype) / text_scale
            k3 = fm.fused_ln_mlp_residual.launches - k3
            set_fused_flags(fa, fm, False)
            if (k2, k3) != (TEXT_DEPTH, TEXT_DEPTH):
                fail(f"text tower: {k2} K2 and {k3} K3 launches, not {TEXT_DEPTH} each")
            gates = (layers.flash_supported, layers.fused_mlp_supported)
            layers.flash_supported = layers.fused_mlp_supported = lambda *a: False
            try:
                plain = ib_model.vision_forward(ib.params, x, ib.cfg, ib.dtype)
                plain_enc = wh_model.encoder_forward(wt.params, mel, wcfg, wt.dtype)[0]
                plain_text = ib_model.text_forward(ib.params, tokens, ib.cfg, ib.dtype) / text_scale
            finally:
                layers.flash_supported, layers.fused_mlp_supported = gates
        report["towers"] = {}
        for name, got in fast.items():
            want = {"whisper_encoder": plain_enc, "text": plain_text, "text_fused": plain_text}.get(name, plain)
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

        # 6. the query path over the store phases 4 and 5 wrote, with the
        # 16 kHz track persisted as the ingest CLI does (core/batch_process
        # save_audio), which the sound pathway re-slices
        for vid in events:
            os.makedirs(os.path.join(mem.store.audio_dir, vid), exist_ok=True)
            np.save(os.path.join(mem.store.audio_dir, vid, "audio.npy"), clip.audio.astype(np.float32))
        qcfg = copy.deepcopy(cfg)
        qcfg.processing.fast_path_confidence = 2.0  # detailed recall, not the fast path
        depths = (ib.cfg.vision.depth, ib.cfg.audio.depth)
        del mem, ib, wh, wt

        # 8. the ingest CLI, building its own engine
        report["cli"] = cli_phase(counters, depths)

        report["query"] = query_phase(qcfg, dict(counters, top_k_cosine=ttk.top_k_cosine_kernel), fa, fm)

    # 9. the QA server from a checkpoint file, after the query phase (the
    # token counter's `transformers` import is paid)
    report["serve"] = serve_phase(dict(counters, top_k_cosine=ttk.top_k_cosine_kernel), depths)

    # 7. search at a store of 200 000 rows
    report["search"] = search_phase(ttk)

    sources = {"flash_mha": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "fused_mlp": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "fused_ln_mlp_residual": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "flash_mha_bthd": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "top_k_cosine": "hippomm_tpu_torch/csrc/topk_cosine.cu"}
    replaces = {"flash_mha": "hippomm_tpu/ops/flash_attention.py:80",
                "fused_mlp": "hippomm_tpu/ops/fused_mlp.py:123",
                "fused_ln_mlp_residual": "hippomm_tpu/ops/fused_mlp.py:153",
                "flash_mha_bthd": "hippomm_tpu/ops/flash_attention.py:319",
                "top_k_cosine": "hippomm_tpu/ops/pallas_topk.py:46"}
    # launches per path, each read from counts set to 0 just before it
    by_path = {f"ingest_{ph}": paths[ph]["launches"] for ph in paths}
    by_path["cli"] = report["cli"]["launches"]
    by_path["query"] = report["query"]["launches"]  # the default-configuration questions
    by_path["query_fused"] = report["query"]["runs"]["video_fused"]["launches"]
    # the server's requests: both /ingest calls, then the questions
    serve_runs = list(report["serve"]["ingest"].values()) + list(report["serve"]["ask"].values())
    by_path["serve"] = {k: sum(r["launches"].get(k, 0) for r in serve_runs) for k in rows}
    # each kernel's own path: K1/K2 the default ingest, K3/K4 the fused one, K5 the query path
    own_path = {"flash_mha": "ingest_default", "fused_mlp": "ingest_default",
                "fused_ln_mlp_residual": "ingest_fused", "flash_mha_bthd": "ingest_fused",
                "top_k_cosine": "query"}
    kernels = []
    for name, rs in rows.items():
        head = rs[0]  # the first shape: vision tower (K1-K4), the JAX store scale (K5)
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": by_path[own_path[name]][name],
            "launches_by_path": {ph: counts.get(name, 0) for ph, counts in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "pct_of_bound": head["pct_of_bound"], "shapes": rs,
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
