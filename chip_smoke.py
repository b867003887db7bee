"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build  — compile the Hopper kernels from hippomm_tpu_torch/csrc with nvcc
  2. kernels — K1 (flash attention), K2 (fused MLP), K3 (LN+MLP+residual)
     and K4 (attention in the (B, T, H, hd) layout) against their plain
     PyTorch versions at every shape the ingest and query paths give them,
     in bf16, and K5 (cosine top-k) in fp32 at stores of 2e5 and 1e6 rows
     and an ascending-sorted 2e5 store, and at 2e5 rows of D 6 and D 1026
     and a D 1024 store view one element into its buffer; then the fp32
     kernels of K1-K4 (csrc/*_f32.cu) against their plain versions in full
     fp32 (TF32 off) at the ingest, Whisper, text and training shapes:
     K1/K4 within 5e-5 abs, K2/K3 within 5e-5 of max |out|, the library
     calls SDPA and F.linear → F.gelu → F.linear at fp32, the bound as
     3×TF32 at 495 TF/s with the fp32 one (67 TF/s) beside it (their
     products are 3×TF32 wgmma), K3 also without its residual;
     kernel, plain and library-call times (CUDA events) beside each bound
     and its share of it; K2/K3 and their library calls timed over rotating
     weight sets that overflow the L2 (as each encoder block finds its
     weights cold), the median of 5 such timings, with their tile plan,
     CUDA kernels per call, device µs per kernel (torch.profiler), host µs
     to enqueue a call; the same readings for K1/K4 (one launch per call,
     warm inputs, the median of 5 timings) and K5 (its plan, kernels per
     call from the profiler: never more than one) with their plans; ptxas's registers, spills,
     shared memory and notes of serialized wgmma for every kernel of
     csrc/*.cu
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
  7. search — (runs after phase 6) a FeatureSearchIndex of 200 000 × 1024
     seeded rows (100 events of 2000): 64 single-query searches through K5
     and one batch of 64, ms per query, 4 queries' hits and times on the
     host route
 11. mesh   — (runs after phase 7, before phase 9) the data-parallel
     serving path over make_mesh(4, devices=[cuda:0] * 4): four "data"
     shards that all sit on the card. An engine built over those devices
     (the mesh from system.mesh_*) ingests phase 4's clip in the default
     and the fused configuration: exact K1-K4 launches by the mesh formula
     (mesh_launches: a divisible tower batch once per shard), every shard's
     vision and audio forward equal bit for bit to the one-device forward
     of its slab, each lockstep Whisper decode equal to each shard's own
     decode, the features against phases 4/5 (2e-2, cosine ≥ 0.999), the
     wall and stages beside the one-device engine's. Then a
     ShardedFeatureIndex of phase 7's store (4 × 50 000 rows): 64 single
     searches (K5 on every shard, 4 launches a round) and a batch of 64,
     hits against the one-device index and the host route, ms beside the
     one-device index's; a store of 50 003 rows (a short last shard holding
     the least negative rows) on both routes. Last, QARecallSystem over a
     mesh engine on phase 6's store picks ShardedFeatureIndex and answers
     the VIDEO question with phase 6's hits, exact K2/K5 launches
 10. train  — (runs after phase 9) contrastive training (train/contrastive) at full
     ImageBind-Huge width: fp32 masters from init_train_state's seed on the
     card, bf16 compute, a fixed seeded batch of 16 image/caption pairs.
     One step's gradients through the kernels (default, then fused
     configuration) and with the kernels routed out in bf16, each held per
     leaf to the same step in fp32 with the kernels routed out: the kernel
     routes' relative L2 error within 2x the bf16 plain route's + 1e-2.
     Then 3 steps in the default and 3 in the fused configuration, each
     from the seeded parameters and a fresh optimizer (lr 5e-5): exact
     K1-K4 launches per step (default: K1 32, K2 32 + 24; fused: K4 32, K3
     32 + 24), a finite loss that falls in each configuration; step ms split
     into forward, backward and optimizer (CUDA events), pairs/s, the
     bound (the step's matmul operations at 989 TF/s bf16) and its share,
     max memory allocated; a fourth default step under torch.profiler:
     device busy ms, idle share and the top CUDA kernels by device time.
     Last, a save_params / load_params round trip of
     the 1.07e9 parameters: every leaf equal and the next step's loss equal
 12. mesh train — (runs after phase 10, whose state it frees first) the
     training half of the parallel layer at full ImageBind-Huge width on
     make_mesh(4, model_parallel=2, devices=[cuda:0] * 4): data 2 × model 2,
     four shards that all sit on the card (the split's cost, not scaling).
     Phase 10's seed and batch of 16 pairs. One tensor-parallel step's
     gradients, gathered per leaf, against phase 10's one-device kernel
     route (relative L2 within 2x the bf16 plain route's error + 1e-2);
     3 TP steps default and 3 fused, each from the seed (K1 2·2·32 and K2
     2·2·56 launches a step, or K4 and K3; a finite loss that falls); one
     ZeRO-1 step against the replicated-moment step (|Δ| ≤ 3e-5 +
     1e-4·|p|) with each position's moment bytes; 3 GPipe steps on (data 1,
     pipe 2, model 2) with 2 microbatches (3 ticks × 32 vision blocks × 2
     model ranks of K1 and of K2, plus 2 × 24 text K2; the first loss
     within 2e-3 of the TP step's; falling); 3 Switch-MoE adapter steps (4
     experts) over the frozen towers (K1 2·32, K2 2·56; falling, the aux
     finite, the dropped tokens counted); save_params of a sharded state
     and load_params(shardings=) with every block its leaf's slice. Each
     path's step ms split into forward, backward and optimizer (CUDA
     events), pairs/s and max memory allocated beside phase 10's, with the
     card's name and power limit. Phase 2 checks the per-shard shapes
     (TRAIN_SHARD_SHAPES), K3 also without its residual
 13. fp32   — (runs after phase 12, whose state it frees first) the JAX
     package's fp32 paths through the fp32 kernels. (a) A new engine with
     models.compute_dtype float32 (ImageBind-Huge in fp32; Whisper
     distil-large-v3 stays bf16, as the engine builds it) ingests phase 4's
     120 s clip in the default and the fused configuration and once with
     the kernels routed out: exact K1-K4 launches by the phase-4/5 formula,
     the ImageBind ones all fp32; features within 1e-3 of max |feature| of
     the routed-out run (cosine ≥ 0.99999) and at cosine ≥ 0.999 to phase
     4/5's bf16 features; wall and stage seconds. (b) Phase 10's seeded 16
     pairs at full width in fp32: one step's gradients through the kernels
     against the kernels routed out, per leaf within 1e-3 relative L2; 3
     steps from the seed (exact fp32 K1/K2 launches, a finite loss that
     falls), step ms split into forward, backward and optimizer, max
     memory. (c) graft_entry.dryrun_multichip(4, devices=[cuda:0] * 4),
     which trains in fp32: its line, every loss finite, and every kernel
     launch an fp32 one
 14. qa     — (runs after phase 13, whose state it frees first) the
     QA-accuracy harness (hippomm_tpu_torch/benchmarks/qa_harness) at
     ImageBind-Huge width in bf16 (random weights from seed 0; OracleASR
     stands in for Whisper). (a) run_harness itself at bench config #5's
     shape over Y4M + WAV: 3 palette videos of 180 s in 15 s scenes (36
     scenes, 320×180 at 2 fps, the last video's colors repeating the
     first's), 120 questions over 12 families at caption noise 0.15, single
     and batched: no failed video, 36 scenes, 120 questions, all 12
     families, qa_accuracy and qa_accuracy_batched ≥ 0.85 (the floor of the
     band the JAX bench calibrated the noise to), count, count_video,
     summary, video_neg and audio_neg at 1.0 (they rest on clean ingest
     captions), exact launches (K1/K2 per encoder block at ingest by
     phase 8's formula, K2 24 per text forward, K5 one per single-question
     search round with k ≤ 128, every round on the device); accuracy with
     its 95 % interval, per family, ingest_x, ingest_wall_s, recall_p50_ms,
     batched_s_per_q. (b) one 180 s video (12 scenes) ingested once, then
     40 questions at caption noise 0 on the single path with the kernels
     and again with them routed out (HIPPOMM_FLASH_ATTN=0,
     HIPPOMM_FUSED_MLP=0, HIPPOMM_TOPK_ROUTE=host): every verdict equal, at
     most 2 answer strings differ (printed), exact launches in the kernel
     pass and none in the routed-out one. Every shape the phase gives
     K1-K5 must be one phase 2 checked (QA_SHAPES adds its own there)
 15. surface — (runs after phase 14, whose state it frees first) the
     port's public surface at ImageBind-Huge bf16 width (random weights
     from a seed). (a) Seeded numpy inputs with no device: 32 frames of
     640×360 uint8, 32 PCM segments of 4 s at 16 kHz (96 clips of 2 s) and
     the 8 questions tokenized, through preprocess_vision →
     preprocess_audio_batch → extract_features(vision=, audio=, text=), in
     the default and the fused-block configuration and with the kernels
     routed out (HIPPOMM_FLASH_ATTN=0, HIPPOMM_FUSED_MLP=0): the inputs on
     CUDA, each output bit-equal to its tower's own forward and within
     2e-2 / cosine ≥ 0.999 of the routed-out pass on unit rows; exact
     launches (default K1 32 + 12, K2 32 + 12 + 24; fused K4 32, K1 12, K3
     32 + 12 + 24; routed out none), every K1-K4 shape one phase 2 checked.
     (b) resize_normalize by every method (nearest, linear, bilinear,
     triangle, cubic, bicubic, lanczos3, lanczos5), antialiased and not, on
     4 of the frames: CUDA within 1e-4 of the same call on the CPU;
     preprocess_vision bit-equal to resize_normalize. (c) resize_frames,
     normalize_nchw, resize_normalize, WhisperMel, KaldiFbank, ssim_pairs,
     rgb_to_gray, frame_difference and window_rms_db given arrays and no
     device: each result on CUDA and bit-equal to the op given the CUDA
     tensors. (d) stacked_blocks over the 32 vision blocks at 16 × 257
     tokens in bf16, remat=True against remat=False, a backward of
     mean(y²) to the input and every block parameter: outputs bit-equal,
     gradients within 1e-3 relative L2, launches K1 and K2 32 each without
     remat and 64 with it (the recompute's forward counted);
     max_memory_allocated of each with the card's name and power limit
 16. vlm    — (runs after phase 15, whose state it frees first) Kimi-VL-A3B-
     Instruct, the in-process captioner (models/kimi_vl), at full width on
     random weights from a seed. (a) K2's tanh-GELU instance
     (hmm_fused_mlp_tanh_bf16) at the ViT chunk the ingest launches
     (vision_chunk key frames of 640×360: 32 × 1196 rows × 1152 × 4352)
     against fused_mlp_ref(approximate="tanh") on the same operands, K2's
     2e-2 of max |out|, and K1 at the chunk's attention shape (32, 16,
     1196, 1196, 72) against its plain version; ms and share of the bound
     of each. (b) An engine built with models.vlm_variant
     "kimi-vl-a3b-instruct" (ImageBind tiny, Whisper stub): its
     frame_client captions 40 seeded 640×360 JPEG key frames in one call,
     with exact K1 and K2 launches read from counts set to 0 just before
     (depth 27 per ViT chunk, ceil(40 / 32) chunks), every decode step a
     graph replay, 40 captions; its summariser writes one summary of the
     40 captions with no K1/K2 launch; one frame's image tokens within
     0.04 relative L2 of the plain fp32 reference's (reference.py, TF32
     off); seconds of each call, decode ms a step, peak memory

Prints the card's name and power limit, a `{"kernels": [...]}` line (the
fp32 kernels as entries of their own, `<name>_f32`, with phase 13's
launches), and as
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
PEAK_TF32_FLOP_S = 495e12  # H100 SXM dense TF32 tensor cores
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


def attention_row(fa, shape, err, kernel, plain, library, b_ms, b_by, plan_shape, f32: bool = False):
    """K1/K4's phase-2 readings: kernel, plain and library ms, the bound and
    its share, the tile plan (the fp32 kernel's with `f32`), CUDA kernels
    per call, device µs per kernel (torch.profiler) and host µs to enqueue
    a call."""
    if f32:
        p32 = fa._attn_plan_f32(*plan_shape)
        plan = {"q_tiles": len(p32.q_tiles), "key_tiles": len(p32.key_tiles), "nc": p32.nc,
                "key_tile": p32.key_tile}
    else:
        p16 = fa._attn_plan(*plan_shape)
        plan = {"q_tiles": len(p16.q_tiles), "key_tiles": [w for _, w in p16.key_tiles],
                "panels": [w for _, _, w in p16.panels]}
    row = {
        "shape": list(shape), "max_abs_err": err,
        "ms": cuda_ms(kernel, iters=20, repeats=5),
        "plain_ms": cuda_ms(plain, iters=3, warmup=1),
        "library_ms": cuda_ms(library, iters=20, repeats=5),
        "bound_ms": b_ms, "bound_by": b_by, "plan": plan, "kernels_per_call": 1,
    }
    row["pct_of_bound"] = 100.0 * b_ms / row["ms"]
    row["device_us"] = device_us([kernel])
    row["host_us"] = host_us([kernel])
    return row


def mlp_operands(shape, gen, ln: bool, dtype=None):
    """x, (gamma, beta,) w1, b1, w2, b2 of one K2 (ln False) or K3 call; x
    and the weights in `dtype` (bf16 by default)."""
    import torch

    dtype = dtype or torch.bfloat16
    n, d, f = shape
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    norm = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev),
            0.1 * torch.randn((d,), generator=gen, device=dev)) if ln else ()
    w1 = (torch.randn((f, d), generator=gen, device=dev) / math.sqrt(d)).to(dtype)
    b1 = 0.1 * torch.randn((f,), generator=gen, device=dev)
    w2 = (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(f)).to(dtype)
    b2 = 0.1 * torch.randn((d,), generator=gen, device=dev)
    return (x, *norm, w1, b1, w2, b2)


def check_mlp_kernel(fm, shape, gen, ln: bool, residual: bool = True, f32: bool = False):
    """K2 (ln False) or K3 against its plain version on one operand set,
    then kernel, plain and library times cycling through weight sets that
    overflow the L2 (each launch finds its weights cold, as on the path).
    residual=False: K3 without its residual (a tensor-parallel shard's
    call other than the first). f32: the fp32 kernels on fp32 operands,
    held to the plain version in full fp32 (TF32 off) within 5e-5 of max
    |out|, with fp32's library chain; their bound is the 3×TF32 one (three
    TF32 products a product at 495 TF/s), beside the fp32 one (67 TF/s)."""
    import functools

    import torch
    import torch.nn.functional as F

    n, d, f = shape
    name = ("fused_ln_mlp_residual" if ln else "fused_mlp") + ("_f32" if f32 else "")
    counter = fm.fused_ln_mlp_residual if ln else fm.fused_mlp
    kernel, plain = counter, (fm.fused_ln_mlp_residual_ref if ln else fm.fused_mlp_ref)
    if not residual:
        kernel, plain = (functools.partial(fn, residual=False) for fn in (kernel, plain))
    tail = (1e-6,) if ln else ()
    dtype, esize, tol = (torch.float32, 4, F32_MLP_TOL) if f32 else (torch.bfloat16, 2, 2e-2)
    sets = operand_sets(lambda: mlp_operands(shape, gen, ln, dtype), 2 * esize * d * f)
    before = counter.launches_f32
    out = kernel(*sets[0], *tail)
    torch.cuda.synchronize()
    if counter.launches_f32 - before != int(f32) or out.dtype != dtype:
        fail(f"{name} {shape}: {counter.launches_f32 - before} fp32 launches, output {out.dtype}")
    ref = plain(*sets[0], *tail)
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not math.isfinite(rel) or rel > tol:
        fail(f"{name} {shape}: max abs err {err} is {rel:.3g} of max|out| > {tol}")

    def library(x, *rest):
        # the cuBLAS chain in the operands' dtype (bf16: biases and the LN
        # affine cast to bf16; fp32: TF32 off)
        g16, bt16, w1, b1h, w2, b2h = rest if ln else (None, None, *rest)
        h = F.layer_norm(x, (d,), g16, bt16, 1e-6) if ln else x
        y = F.linear(F.gelu(F.linear(h, w1, b1h)), w2, b2h)
        return x + y if ln and residual else y

    lib_args = [tuple(t.to(dtype) if t.dtype == torch.float32 else t for t in s) for s in sets]
    # x read and out written once, W1 and W2 once, the (D,)/(F,) vectors once
    nbytes = esize * (2 * n * d + 2 * d * f) + 4 * (f + (3 if ln else 1) * d)
    if f32:
        b_ms, b_by = bound(nbytes, 3 * 4 * n * d * f, PEAK_TF32_FLOP_S)
        fp32_ms, fp32_by = bound(nbytes, 4 * n * d * f, PEAK_FP32_FLOP_S)
    else:
        b_ms, b_by = bound(nbytes, 4 * n * d * f)
    plan = fm._plan_f32(n, d, f) if f32 else fm._plan(n, d, f)
    row = {
        "shape": list(shape), "max_abs_err": err, "rel_err": rel, "operand_sets": len(sets),
        **({} if residual else {"residual": False}),
        "plan": plan._asdict(), "kernels_per_call": fm.kernels_per_call(plan, ln, f32),
        "ms": cuda_ms([lambda s=s: kernel(*s, *tail) for s in sets], repeats=5),
        "plain_ms": cuda_ms([lambda s=s: plain(*s, *tail) for s in sets], iters=3, warmup=1),
        "library_ms": cuda_ms([lambda a=a: library(*a) for a in lib_args], repeats=5),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["pct_of_bound"] = 100.0 * b_ms / row["ms"]
    if f32:
        row.update(fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by, pct_of_fp32_bound=100.0 * fp32_ms / row["ms"])
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


F32_ATTN_TOL = 5e-5  # fp32 K1/K4 against the plain version in full fp32, max abs
F32_MLP_TOL = 5e-5  # fp32 K2/K3, of max |out|


def check_attention_f32(fa, shape, gen, bthd: bool):
    """The fp32 K1 (B, H, T, hd) or K4 (B, T, H, hd slices of one packed
    (B, T, 3D) projection) against its plain version in full fp32 (TF32
    off), then the readings of attention_row; the library call is SDPA at
    fp32; the bound is the 3×TF32 one (three TF32 products a product at 495
    TF/s: csrc/flash_mha_f32.cu's), beside the fp32 one (67 TF/s)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    if bthd:
        b, t, h, hd = shape
        tq = tk = t
        d = h * hd
        qkv = torch.randn((b, t, 3 * d), generator=gen, device=dev)
        q, k, v = (qkv[..., i * d : (i + 1) * d].reshape(b, t, h, hd) for i in range(3))
        kernel_fn, plain_fn = fa.flash_mha_bthd, fa.flash_mha_bthd_ref
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    else:
        b, h, tq, tk, hd = shape
        q, k, v = (torch.randn((b, h, t, hd), generator=gen, device=dev) for t in (tq, tk, tk))
        kernel_fn, plain_fn = fa.flash_mha, fa.flash_mha_ref
        qt, kt, vt = q, k, v
    scale = 1.0 / math.sqrt(hd)
    before = kernel_fn.launches_f32
    out = kernel_fn(q, k, v, scale)
    torch.cuda.synchronize()
    if kernel_fn.launches_f32 != before + 1 or out.dtype != torch.float32:
        fail(f"{kernel_fn.__name__} fp32 {shape}: not one fp32 kernel launch")
    err = (out - plain_fn(q, k, v, scale)).abs().max().item()
    if not math.isfinite(err) or err > F32_ATTN_TOL:
        fail(f"{kernel_fn.__name__} fp32 {shape}: max abs err {err} > {F32_ATTN_TOL}")
    nbytes, flops = 4 * b * h * hd * (2 * tq + 2 * tk), 4 * b * h * tq * tk * hd
    b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_S)
    row = attention_row(fa, shape, err, lambda: kernel_fn(q, k, v, scale), lambda: plain_fn(q, k, v, scale),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), b_ms, b_by,
                        (tq, tk, hd), f32=True)
    fp32_ms, fp32_by = bound(nbytes, flops, PEAK_FP32_FLOP_S)
    row.update(fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by, pct_of_fp32_bound=100.0 * fp32_ms / row["ms"])
    return row


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


def check_topk(ttk, shape, gen, ascending: bool = False, offset: int = 0):
    """K5 over a store of unit rows (as the search route normalizes it once
    at upload) and a random query; with `ascending`, the rows sorted by
    their similarity to it, lowest first (every row beats each block's
    running threshold: the filter's worst case); with `offset`, the store a
    view starting that many elements into its buffer (not 16-byte aligned).
    Kernel, plain and library ms, its plan, CUDA kernels per call, device
    µs per kernel (torch.profiler) and host µs to enqueue a call."""
    import torch

    n, d, k = shape
    dev = torch.device("cuda")
    flat = torch.randn((n * d + offset,), generator=gen, device=dev)
    feats = flat[offset:].view(n, d)
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
        fail(f"top_k_cosine {shape}{' ascending' if ascending else ''} offset {offset}: {bad}")
    # the store read once, q read and k values + k indices written once;
    # 4 flops per element (dot and sum of squares) on the fp32 CUDA cores
    b_ms, b_by = bound(4 * n * d + 4 * d + 8 * k, 4 * n * d, PEAK_FP32_FLOP_S)
    kernel = lambda: ttk.top_k_cosine_kernel(q, feats, k)  # noqa: E731
    us, per_call = profile_kernels([kernel])
    row = {
        "shape": list(shape), "ascending": ascending, "offset": offset,
        "max_abs_err": (vals - rvals).abs().max().item(),
        "ms": cuda_ms(kernel, iters=20, repeats=5),
        "plain_ms": cuda_ms(lambda: ttk.top_k_cosine_ref(q, feats, k), iters=3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.topk(feats @ qn, k), iters=20, repeats=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "plan": ttk._topk_plan(n, d, k, torch.cuda.get_device_properties(0).multi_processor_count,
                               feats.data_ptr() % 16 // 4)._asdict(),
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
    for source in native.KERNEL_SOURCES:
        log = native.build_log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
        for block in log.split("Compiling entry function '")[1:]:
            mangled = block.split("'", 1)[0]
            attn = re.search(r"flash_mha_kernelILi(\d+)E", mangled)
            attn32 = re.search(r"flash_mha_f32_kernelILi(\d+)E", mangled)
            gemm = re.search(r"gemm_tnILi(\d+)ELi(\d+)E", mangled)
            gemm32 = re.search(r"gemm_tf32x3ILi(\d+)ELi(\d+)E", mangled)
            kind = re.search(
                r"\d+(layer_norm_rows_f32|layer_norm_rows|split_rows_f32|splitk_reduce_f32|splitk_reduce)E",
                mangled)
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            smem = re.search(r"(\d+) bytes smem", block)
            if attn:
                name, dyn = f"flash_mha_kernel<hd {attn.group(1)}>", native.kernels().hmm_flash_mha_smem_bytes(
                    int(attn.group(1)))
            elif attn32:
                nc = int(attn32.group(1))
                name = f"flash_mha_f32_kernel<hd {16 * nc}>"
                dyn = native.kernels().hmm_flash_mha_f32_smem_bytes(nc)
            elif gemm:
                name = f"gemm_tn<BN {gemm.group(1)}, {_EPILOGUES[gemm.group(2)]}>"
                dyn = native.kernels().hmm_fused_mlp_smem_bytes(int(gemm.group(1)))
            elif gemm32:
                name = f"gemm_tf32x3<BN {gemm32.group(1)}, {_EPILOGUES[gemm32.group(2)]}>"
                dyn = native.kernels().hmm_fused_mlp_f32_smem_bytes(int(gemm32.group(1)))
            elif "topk_cosine" in mangled:
                vec = "ILb1E" in mangled
                name = f"topk_cosine<{'float4' if vec else 'element-wise'}>"
                dyn = topk_plan["smem_bytes"] if vec else None
            else:
                name, dyn = (kind.group(1) if kind else mangled), 0
            out.append({
                "source": source, "kernel": name,
                "registers": int(used.group(1)) if used else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None,
                "static_smem": int(smem.group(1)) if smem else 0,
                "dynamic_smem": dyn,
                # ptxas's notes (C7510-C7520) that it serialized the kernel's wgmmas
                "wgmma_serialized_notes": sum(1 for ln in log.splitlines()
                                              if "wgmma.mma_async instructions are serialized" in ln and mangled in ln),
            })
    return out


def ingest_expect(stms, ib_cfg, wh_blocks: int, fused: bool):
    """The K1-K4 launches of one process_sequence by the phase-4/5 formula:
    the vision tower's blocks once per vision chunk (128 frames, or 32 for
    the rest), the audio tower's once per 32 audio segments, and
    `wh_blocks` Whisper encoder blocks (K1 and K2 each); the fused
    configuration puts every ImageBind block on K3 and the vision blocks
    (H 16) on K4. Returns them with the frames, vision chunks and audio
    segments counted."""
    n_frames = sum(len(s.segment_info["frames"]) for s in stms)
    n_vis_chunks, lo = 0, 0
    while lo < n_frames:
        lo += 128 if n_frames - lo >= 128 else 32
        n_vis_chunks += 1
    n_aud = sum(1 for s in stms if "audio" in s.features)
    vis_blocks = n_vis_chunks * ib_cfg.vision.depth
    aud_blocks = math.ceil(n_aud / 32) * ib_cfg.audio.depth
    if fused:
        expect = {"flash_mha": aud_blocks + wh_blocks, "fused_mlp": wh_blocks,
                  "fused_ln_mlp_residual": vis_blocks + aud_blocks, "flash_mha_bthd": vis_blocks}
    else:
        expect = {"flash_mha": vis_blocks + aud_blocks + wh_blocks,
                  "fused_mlp": vis_blocks + aud_blocks + wh_blocks,
                  "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}
    return expect, n_frames, n_vis_chunks, n_aud


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
    return out, index, events, queries


MESH_SHARDS = 4  # phase 11: "data" shards, all on the one card
# The kernels' shapes on one of phase 11's shards, checked in phase 2: a
# 32-frame vision chunk is 4 × 8 frames (K1/K4 batch 8, K2/K3 8 × 257 rows);
# an audio chunk of 32 segments × 3 clips is 4 × 24 clips (K1 (24, 12, 229,
# 230, 64), K2/K3 24 × 229 rows); Whisper's batch of 4 chunks is 4 × 1 (K1
# (1, 20, 1500, 1500, 64), K2 1500 rows); the 2e5-row store is 4 × 5e4 rows
# and the 50 003-row store's shards hold 12 501 rows (K5, search's first
# round k 40).
SHARD_SHAPES = {
    "flash_mha": ((8, 16, 257, 257, 80), (24, 12, 229, 230, 64), (1, 20, 1500, 1500, 64)),
    "fused_mlp": ((2056, 1280, 5120), (5496, 768, 3072), (1500, 1280, 5120)),
    "fused_ln_mlp_residual": ((2056, 1280, 5120), (5496, 768, 3072)),
    "flash_mha_bthd": ((8, 257, 16, 80),),
    "top_k_cosine": ((50_000, 1024, 40), (12_501, 1024, 40)),
}


TRAIN_MESH = {"data": 2, "model": 2}  # phase 12: four shards on the one card
# The kernels' shapes on one of phase 12's shards, checked in phase 2: a
# batch of 16 pairs on (data 2, model 2) is 8 pairs a shard at heads/2 and
# hidden/2 (K1 (8, 8, 257, 257, 80), K4 (8, 257, 8, 80), K2/K3 8 × 257
# vision rows at F 2560 and 8 × 77 text rows at F 2048; K3 also without its
# residual, the second model rank's call); a GPipe microbatch on (pipe 2,
# model 2) is 8 pairs over 258 padded tokens (K1 q 258, k/v 257; K2 8 × 258).
TRAIN_SHARD_SHAPES = {
    "flash_mha": ((8, 8, 257, 257, 80), (8, 8, 258, 257, 80)),
    "fused_mlp": ((2056, 1280, 2560), (616, 1024, 2048), (2064, 1280, 2560)),
    "fused_ln_mlp_residual": ((2056, 1280, 2560), (616, 1024, 2048)),
    "flash_mha_bthd": ((8, 257, 8, 80),),
}


# The kernels' shapes in phase 14 that no other phase gives them, checked in
# phase 2 (phase 14 fails on any shape phase 2 did not check): the batched
# path's one text forward of 40 VIDEO questions (77 × 40 rows), and K5 over
# the harness's vision stores, 36 rows (3 videos × 12 scenes) and 12 (one
# video), k clamped to the rows. Its vision and audio chunks are phase 4's
# (32 frames; 32 segments × 3 clips), its single questions' text rows 77.
QA_SHAPES = {
    "fused_mlp": ((3080, 1024, 4096),),
    "top_k_cosine": ((36, 1024, 36), (12, 1024, 12)),
}


def mesh_launches(n_vis_chunks, n_aud, enc_batches, bucket, vis_depth, aud_depth, fused, shards):
    """K1-K4 launches of one ingest on a mesh: every tower batch whose rows
    divide by the shard count runs once per shard (vision chunks of 32/128,
    audio chunks of 32, Whisper buckets of 4/16/32), an indivisible one
    once."""
    per = lambda rows: shards if rows % shards == 0 else 1  # noqa: E731
    vis = n_vis_chunks * per(32) * vis_depth
    aud = math.ceil(n_aud / 32) * per(32) * aud_depth
    wh = enc_batches * per(bucket) * WHISPER_DEPTH
    if fused:
        return {"flash_mha": aud + wh, "fused_mlp": wh, "fused_ln_mlp_residual": vis + aud,
                "flash_mha_bthd": vis}
    return {"flash_mha": vis + aud + wh, "fused_mlp": vis + aud + wh, "fused_ln_mlp_residual": 0,
            "flash_mha_bthd": 0}


class _Patch:
    """Attributes replaced for a phase and put back after it."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, new):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def restore(self):
        for obj, name, old in reversed(self.saved):
            setattr(obj, name, old)
        self.saved = []


def mesh_phase(cfg, qcfg, clip, one_device, counters, fa, fm, ttk, search, video_result):
    """Phase 11: the data-parallel serving path on a mesh of 4 "data" shards
    that all sit on the card (make_mesh(4, devices=[cuda:0] * 4)): the
    engine's ingest of phase 4's clip (default and fused), the 4-shard
    index over phase 7's store, and a VIDEO question over phase 6's store.
    Each shard's tower forwards are held bit for bit to the one-device
    forward of its slab, the sharded Whisper decode to each shard's own
    decode, the features to the one-device engine's (phases 4 and 5), the
    hits to the one-device index's and the host route's; exact launches."""
    import numpy as np
    import torch

    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.memory.schema import ThetaEvent
    from hippomm_tpu_torch.models.imagebind import model as ib_model
    from hippomm_tpu_torch.models.whisper import model as wh_model
    from hippomm_tpu_torch.models.whisper import transcribe as wh_transcribe
    from hippomm_tpu_torch.parallel.sharded_store import ShardedFeatureIndex
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex

    start = time.perf_counter()
    devices = [torch.device("cuda", 0)] * MESH_SHARDS
    out = {"shards": MESH_SHARDS, "ingest": {}}
    with tempfile.TemporaryDirectory() as mesh_dir:
        mcfg = copy.deepcopy(cfg)
        mcfg.storage.base_dir = mesh_dir
        mem = HippocampalMemory(mcfg, devices=devices)
        if mem.mesh is None or mem.mesh.shape != {"data": MESH_SHARDS, "model": 1}:
            fail(f"mesh: the engine over {MESH_SHARDS} devices built {mem.mesh}")
        if not (mem.imagebind.mesh is mem.mesh and mem.whisper._impl.mesh is mem.mesh):
            fail("mesh: the engine did not hand its mesh to both towers")
        ib, wt = mem.imagebind, mem.whisper._impl
        wcfg = wt.cfg

        # 1. the engine's ingest through the mesh, default then fused
        for phase, video_id, fused in (("default", "clip_mesh", False), ("fused", "clip_mesh_fused", True)):
            set_fused_flags(fa, fm, fused)
            forwards, decodes, patch = [], [], _Patch()
            for name in ("vision_forward", "audio_forward"):
                real = getattr(ib_model, name)
                patch.set(ib_model, name, lambda p, x, c, d, real=real: forwards.append(
                    (real, p, x, real(p, x, c, d))) or forwards[-1][3])
            real_dec = wt._graphs.decode  # the transcriber's greedy decode
            patch.set(wt._graphs, "decode", lambda shards, c, **k: decodes.append(
                (list(shards), k, real_dec(shards, c, **k))) or decodes[-1][2])
            stages_before = dict(mem.timers.totals)
            try:
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
            finally:
                patch.restore()
            one = one_device[phase]
            n_frames = sum(len(s.segment_info["frames"]) for s in stms)
            n_aud = sum(1 for s in stms if "audio" in s.features)
            expect = mesh_launches(one["vision_chunks"], n_aud, one["encoder_batches"], one["bucket"],
                                   ib.cfg.vision.depth, ib.cfg.audio.depth, fused, MESH_SHARDS)
            stages = {k: v - stages_before.get(k, 0.0) for k, v in mem.timers.totals.items()}
            print(f"mesh engine {phase}: {len(stms)} segments, {n_frames} frames, {n_aud} audio segments; "
                  f"launches {launches}, expected {expect}; wall {wall:.3f} s on {MESH_SHARDS} shards "
                  f"against {one['wall_s']:.3f} s on one device (phase {5 if fused else 4})", flush=True)
            print(f"mesh stages {phase}: " + json.dumps({k: round(v, 4) for k, v in stages.items()})
                  + " against one device " + json.dumps({k: round(v, 4) for k, v in one["stages_s"].items()}),
                  flush=True)
            if launches != expect:
                fail(f"mesh {phase}: kernel launches {launches} != {expect}")
            if (len(stms), n_frames, n_aud) != (one["segments"], one["frames"], one["audio_segments"]):
                fail(f"mesh {phase}: {len(stms)} segments / {n_frames} frames / {n_aud} audio segments, one "
                     f"device {one['segments']} / {one['frames']} / {one['audio_segments']}")
            # every shard's forward against the one-device forward of its slab
            slabs = {"vision_forward": [], "audio_forward": []}
            with torch.no_grad():
                for real, p, x, got in forwards:
                    if not torch.equal(real(p, x, ib.cfg, ib.dtype), got):
                        fail(f"mesh {phase}: a shard's {real.__name__} differs from the one-device "
                             f"forward of its slab")
                    slabs[real.__name__].append(x.shape[0])
            if slabs != {"vision_forward": [8] * (MESH_SHARDS * one["vision_chunks"]),
                         "audio_forward": [8] * (MESH_SHARDS * math.ceil(n_aud / 32))}:
                fail(f"mesh {phase}: tower slabs {slabs}")
            # the lockstep decode against each shard's own decode
            steps = []
            for shards, kw, result in decodes:
                if len(shards) != MESH_SHARDS:
                    fail(f"mesh {phase}: a Whisper decode of {len(shards)} shards")
                for (p, enc, prompt), (tok, ln) in zip(shards, result):
                    if enc.shape[0] != one["bucket"] // MESH_SHARDS:  # SHARD_SHAPES' Whisper rows
                        fail(f"mesh {phase}: a Whisper shard of {enc.shape[0]} chunks")
                    tok1, ln1 = wh_model.greedy_decode(p, enc, prompt, wcfg, **kw)
                    ends = [min(int(n) + 1, tok.shape[1]) for n in ln.tolist()]
                    if not (torch.equal(ln, ln1) and all(torch.equal(tok[j, :e], tok1[j, :e])
                                                         for j, e in enumerate(ends))):
                        fail(f"mesh {phase}: a shard's lockstep tokens differ from its own decode")
                    steps.append(max(ends) - prompt.shape[1])
            if len(decodes) != one["encoder_batches"]:
                fail(f"mesh {phase}: {len(decodes)} decodes for {one['encoder_batches']} encoder batches")
            agree = {}
            for mod, norm in (("vision", 1.0), ("audio", 20.0)):
                a = np.concatenate([s.features[mod] for s in stms if mod in s.features])
                b = one[mod]
                err = float(np.abs(a - b).max()) / norm if a.shape == b.shape else float("inf")
                cos = float((np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())
                agree[mod] = {"max_abs_err": err, "min_cosine": cos}
                if not (math.isfinite(err) and err <= 2e-2 and cos >= 0.999):
                    fail(f"mesh {phase} {mod} features disagree with one device: {err}, cos {cos}")
            print(f"mesh {phase}: features against one device "
                  + ", ".join(f"{m} (÷{n:g}) max abs {agree[m]['max_abs_err']:.3g} min cosine "
                              f"{agree[m]['min_cosine']:.6f}" for m, n in (("vision", 1), ("audio", 20)))
                  + f"; {len(forwards)} shard forwards equal to the one-device forward of their slabs; "
                  f"{len(decodes)} decodes of {MESH_SHARDS} shards in lockstep equal to each shard's "
                  f"own decode (steps {steps})", flush=True)
            out["ingest"][phase] = {"wall_s": wall, "one_device_wall_s": one["wall_s"], "stages_s": stages,
                                    "one_device_stages_s": one["stages_s"], "launches": launches,
                                    "expected_launches": expect, "features_vs_one_device": agree,
                                    "shard_forwards": len(forwards), "decode_steps": steps}
        set_fused_flags(fa, fm, False)
        mesh = mem.mesh
        del mem, ib, wt, forwards, decodes

    # 2. the 4-shard index over phase 7's store
    index, events, queries = search
    t0 = time.perf_counter()
    sharded = ShardedFeatureIndex.build(events, "vision", mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if [f.shape[0] for _, f in sharded._shards.parts] != [len(index) // MESH_SHARDS] * MESH_SHARDS:
        fail(f"mesh search: shards {[f.shape for _, f in sharded._shards.parts]}")
    rounds, patch = [], _Patch()
    real_topk = ShardedFeatureIndex._topk
    patch.set(ShardedFeatureIndex, "_topk", lambda idx, q, k: rounds.append(k) or real_topk(idx, q, k))
    os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
    try:
        one_ms, one_hits = [], []
        for i in range(64):
            t1 = time.perf_counter()
            one_hits.append(index.search(queries[i]))
            one_ms.append((time.perf_counter() - t1) * 1e3)
        ttk.top_k_cosine_kernel.launches = 0
        mesh_ms, mesh_hits = [], []
        for i in range(64):
            t1 = time.perf_counter()
            mesh_hits.append(sharded.search(queries[i]))
            mesh_ms.append((time.perf_counter() - t1) * 1e3)
        launches = ttk.top_k_cosine_kernel.launches
        k5_rounds = [k for k in rounds if k <= 128]
        host_q = queries.cpu().numpy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one_batch = index.search_batch(host_q)
        one_batch_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        mesh_batch = sharded.search_batch(host_q)
        mesh_batch_ms = (time.perf_counter() - t1) * 1e3
    finally:
        patch.restore()
    if launches != MESH_SHARDS * len(k5_rounds) or not k5_rounds:
        fail(f"mesh search: {launches} K5 launches for {len(k5_rounds)} rounds of {MESH_SHARDS} shards")
    err, ties = 0.0, 0
    for i in range(64):
        for got, want, what in ((mesh_hits[i], one_hits[i], "search"), (mesh_batch[i], one_batch[i], "batch")):
            e, t = compare_hits(index, host_q[i], got, want, f"mesh {what} query {i} against one device")
            err, ties = max(err, e), ties + t
    os.environ["HIPPOMM_TOPK_ROUTE"] = "host"
    try:
        for i in range(4):
            want = index.search(host_q[i])
            e, t = compare_hits(index, host_q[i], mesh_hits[i], want, f"mesh search query {i} against host")
            err, ties = max(err, e), ties + t
    finally:
        os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
    out["search"] = {"rows": len(index), "build_s": build_s, "single_ms_median": float(np.median(mesh_ms)),
                     "one_device_single_ms_median": float(np.median(one_ms)), "single_ms": mesh_ms,
                     "batch64_ms": mesh_batch_ms, "one_device_batch64_ms": one_batch_ms,
                     "k5_launches": launches, "k5_rounds": len(k5_rounds), "max_sim_gap": err,
                     "near_ties": ties}
    print(f"mesh search: {len(index)} rows over {MESH_SHARDS} shards (built in {build_s:.2f} s); single "
          f"query {np.median(mesh_ms):.3f} ms median against {np.median(one_ms):.3f} ms on one device; "
          f"batch of 64 {mesh_batch_ms:.3f} ms against {one_batch_ms:.3f} ms; {launches} K5 launches for "
          f"{len(k5_rounds)} rounds; hits agree with the one-device index and the host route (similarity "
          f"gap {err:.3g}, {ties} near-tie ranks)", flush=True)
    del sharded

    # ... and a store whose rows do not divide by 4, with negative scores:
    # 50 003 rows, the least negative in the short last shard, two positive
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, d = 50_003, 1024
    q = torch.randn((d,), generator=gen, device="cuda")
    rows = torch.randn((n, d), generator=gen, device="cuda") - 2.0 * q
    rows[40_000:] += 1.8 * q
    rows[4], rows[11] = q, q + 0.3 * torch.randn((d,), generator=gen, device="cuda")
    rows = rows.cpu().numpy()
    small = [ThetaEvent(video_id=f"n{e}", features={"vision": rows[lo:lo + 5000]},
                        feature_times={"vision": [float(t) for t in range(len(rows[lo:lo + 5000]))]},
                        start_time=0.0, end_time=5000.0) for e, lo in enumerate(range(0, n, 5000))]
    one_small = FeatureSearchIndex.build(small, "vision", devices[0])
    sharded_small = ShardedFeatureIndex.build(small, "vision", mesh)
    last = sharded_small._shards.parts[-1][0]
    qh = q.cpu().numpy()
    for kw in ({}, {"top_k_per_event": 200, "global_top_k": 150}):  # K5, then the k > 128 route
        got = sharded_small.search(q, **kw)
        compare_hits(one_small, qh, got, one_small.search(q, **kw), f"mesh short-shard store {kw}")
        os.environ["HIPPOMM_TOPK_ROUTE"] = "host"
        try:
            compare_hits(one_small, qh, got, one_small.search(qh, **kw), f"mesh short-shard store {kw} host")
        finally:
            os.environ.pop("HIPPOMM_TOPK_ROUTE", None)
        hit_rows = [int(h.video_id[1:]) * 5000 + h.index_in_event for h in got]
        if sum(h.similarity > 0 for h in got) != 2 or min(hit_rows[2:]) < last:
            fail(f"mesh short-shard store: hits {[(r, h.similarity) for r, h in zip(hit_rows, got)][:8]}")
    print(f"mesh short-shard store: {n} rows over {MESH_SHARDS} shards ({[f.shape[0] for _, f in sharded_small._shards.parts]}); "
          f"the negative rows of the last shard (from row {last}) rank as on one device and the host route",
          flush=True)
    del one_small, sharded_small, small, rows

    # 3. a VIDEO question over phase 6's store through a mesh engine
    qmem = HippocampalMemory(qcfg, devices=devices)
    qmem.load_all_events()
    qa = QARecallSystem(qmem, qcfg)
    idx = qa._index("vision")
    if not isinstance(idx, ShardedFeatureIndex):
        fail(f"mesh question: QARecallSystem built {type(idx).__name__}, not ShardedFeatureIndex")
    text_rows, enc_calls, rounds, patch = [], [], [], _Patch()
    real_text, real_enc = ib_model.text_forward, wh_transcribe.encoder_forward
    patch.set(ib_model, "text_forward", lambda p, t, *a: text_rows.append(t.numel()) or real_text(p, t, *a))
    patch.set(wh_transcribe, "encoder_forward", lambda *a, **k: enc_calls.append(1) or real_enc(*a, **k))
    patch.set(ShardedFeatureIndex, "_topk_device",
              lambda ix, qq, k, f=ShardedFeatureIndex._topk_device: rounds.append(k) or f(ix, qq, k))
    try:
        for c in list(counters.values()) + [ttk.top_k_cosine_kernel]:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = qa.answer_question(VIDEO_Q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        launches["top_k_cosine"] = ttk.top_k_cosine_kernel.launches
    finally:
        patch.restore()
    shards_used = len(idx._shards.parts)
    expect = {"flash_mha": WHISPER_DEPTH * len(enc_calls),
              "fused_mlp": TEXT_DEPTH * len(text_rows) + WHISPER_DEPTH * len(enc_calls),
              "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0,
              "top_k_cosine": shards_used * sum(1 for k in rounds if k <= 128)}
    print(f"mesh question VIDEO: wall {wall:.3f} s; text rows {text_rows} (one question does not divide "
          f"by {MESH_SHARDS}: one forward), search rounds k {rounds} over {shards_used} non-empty shards; "
          f"launches {launches}, expected {expect}", flush=True)
    if launches != expect or not rounds or text_rows != [77]:
        fail(f"mesh question: launches {launches} != {expect} (rounds {rounds}, text rows {text_rows})")
    want = video_result["retrieved_segments"]
    got = [h for h in res.retrieved_segments]
    if res.question_type != "VIDEO" or [(h["event_id"], h["time"], h["index_in_event"]) for h in got] != [
            (h["event_id"], h["time"], h["index_in_event"]) for h in want]:
        fail(f"mesh question: hits {got} differ from phase 6's {want}")
    gap = max((abs(a["similarity"] - b["similarity"]) for a, b in zip(got, want)), default=0.0)
    if not gap <= 1e-5:
        fail(f"mesh question: similarities differ from phase 6's by {gap}")
    print(f"mesh question VIDEO: {len(got)} hits equal to phase 6's (similarity gap {gap:.3g})", flush=True)
    out["query"] = {"wall_s": wall, "launches": launches, "expected_launches": expect, "hits": len(got),
                    "search_rounds_k": rounds, "shards_used": shards_used}
    del qa, qmem, idx
    out["phase_s"] = time.perf_counter() - start
    print(f"mesh: phase 11 took {out['phase_s']:.1f} s", flush=True)
    return out


TRAIN_B = 16  # pairs a step
TRAIN_STEPS = 3  # steps in each configuration
TRAIN_LR = 5e-5
GRAD_FACTOR, GRAD_FLOOR = 2.0, 1e-2  # kernel route vs the bf16 plain route, per leaf


def train_flops(cfg, b: int) -> float:
    """Matmul operations of one training step (forward, and a backward of
    twice the forward's products) of the vision and text towers, from the
    shapes: per block the QKV, attention (both products, every key: the
    text tower's causal mask is applied to a full product), out-projection
    and MLP products; the patchify and both heads. Recomputes (the kernels'
    backward) are the implementation's, not the work's: not counted."""
    def tower(t, width, depth):
        f = int(width * 4)
        per_block = 2 * t * width * (3 * width) + 4 * t * t * width + 2 * t * width * width + 4 * t * width * f
        return depth * per_block
    tv = cfg.vision_tokens
    fwd = tower(tv, cfg.vision.width, cfg.vision.depth)
    fwd += tower(cfg.context_length, cfg.text.width, cfg.text.depth)
    fwd += 2 * (tv - 1) * (3 * cfg.patch_size ** 2) * cfg.vision.width
    fwd += 2 * cfg.embed_dim * (cfg.vision.width + cfg.text.width)
    return 3.0 * b * fwd


class StepTimer:
    """CUDA events around the three parts of a training step, recorded on
    the stream as the step enqueues them: the forward ends when the loss
    function (`tc.<loss_name>`) returns, the backward when the optimizer's
    update starts, the update when it returns."""

    def __init__(self, tc, optimizer, loss_name: str = "contrastive_loss"):
        import torch

        self.tc, self.optimizer, self.loss_name = tc, optimizer, loss_name
        self.real_loss = getattr(tc, loss_name)
        self.events = None
        real_step = optimizer.step

        def loss(*a, **k):
            out = self.real_loss(*a, **k)
            self._mark("forward")
            return out

        def update(*a, **k):
            self._mark("backward")
            real_step(*a, **k)
            self._mark("optimizer")

        setattr(tc, loss_name, loss)
        optimizer.step = update
        self._event = lambda: torch.cuda.Event(enable_timing=True)

    def _mark(self, name):
        if self.events is not None:
            self.events[name] = self._event()
            self.events[name].record()

    def start(self):
        self.events = {"start": self._event()}
        self.events["start"].record()

    def read(self):
        """ms of forward, backward and optimizer (after a synchronize)."""
        e = self.events
        return {"forward": e["start"].elapsed_time(e["forward"]),
                "backward": e["forward"].elapsed_time(e["backward"]),
                "optimizer": e["backward"].elapsed_time(e["optimizer"])}

    def restore(self):
        setattr(self.tc, self.loss_name, self.real_loss)
        del self.optimizer.step


def profile_step(fn, top: int = 12):
    """One call of `fn` under torch.profiler (CUDA activity only): its wall
    ms (to a synchronize), the device's busy ms (the union of the kernels'
    intervals) and idle share over the wall, and the `top` CUDA kernels by
    total device µs with their counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / 1e3 / wall,
            "kernels": len(spans), "top": [{"name": k[:90], "us": us, "count": n} for k, (us, n) in kernels]}


def train_batch(cfg):
    """The training phases' fixed seeded batch of TRAIN_B pairs:
    normalized-image-like pixels, and captions of seeded lengths ending in
    EOS (the largest id), zero-padded as the tokenizer pads them."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    images = torch.randn((TRAIN_B, 3, cfg.image_size, cfg.image_size), generator=gen, device=dev)
    t = cfg.context_length
    tokens = torch.randint(1, cfg.vocab_size - 1, (TRAIN_B, t), generator=gen, device=dev)
    lengths = torch.randint(8, t, (TRAIN_B,), generator=gen, device=dev)
    tokens = torch.where(torch.arange(t, device=dev) < lengths[:, None], tokens, 0)
    tokens[torch.arange(TRAIN_B, device=dev), lengths] = cfg.vocab_size - 1
    return images, tokens


def train_phase(fa, fm, counters):
    """10. contrastive training at full ImageBind-Huge width (see the
    module doc)."""
    import gc

    import torch

    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.models.imagebind.model import huge_config
    from hippomm_tpu_torch.train import checkpoint as ck
    from hippomm_tpu_torch.train import contrastive as tc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live_before = torch.cuda.memory_allocated()
    cfg = huge_config()
    t0 = time.perf_counter()
    params, opt = tc.init_train_state(cfg, learning_rate=TRAIN_LR, seed=10)  # CUDA by default
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in ck.flatten_params(params).values())
    images, tokens = train_batch(cfg)
    vis, txt = cfg.vision.depth, cfg.text.depth
    expect = {False: {"flash_mha": vis, "fused_mlp": vis + txt, "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0},
              True: {"flash_mha": 0, "fused_mlp": 0, "fused_ln_mlp_residual": vis + txt, "flash_mha_bthd": vis}}

    def grads(dtype, plain: bool):
        """One forward and backward at the current parameters; with `plain`,
        the kernels routed out (their shape gates shut)."""
        gates = (layers.flash_supported, layers.fused_mlp_supported, fa.bthd_supported)
        if plain:
            layers.flash_supported = layers.fused_mlp_supported = fa.bthd_supported = lambda *a: False
        try:
            metrics, g = tc.loss_and_grads(params, images, tokens, cfg, dtype)
        finally:
            layers.flash_supported, layers.fused_mlp_supported, fa.bthd_supported = gates
        return float(metrics["loss"]), g

    def rel_errs(g, ref):
        return {k: ((g[k] - r).norm() / r.norm().clamp_min(1e-30)).item() for k, r in ref.items() if r is not None}

    # gradients through the kernels against the kernels routed out, both
    # held to an fp32 step with the kernels routed out (TF32 off)
    t0 = time.perf_counter()
    loss32, ref = grads(torch.float32, True)
    errs = {"plain_bf16": rel_errs(grads(torch.bfloat16, True)[1], ref)}
    carry = {"images": images, "tokens": tokens}  # what phase 12 holds the mesh step to
    for name, fused in (("kernels_default", False), ("kernels_fused", True)):
        set_fused_flags(fa, fm, fused)
        for c in counters.values():
            c.launches = 0
        loss_k, g = grads(torch.bfloat16, False)
        launched = {n: c.launches for n, c in counters.items()}
        if launched != expect[fused]:
            fail(f"train {name}: gradient forward launched {launched}, not {expect[fused]}")
        errs[name] = rel_errs(g, ref)
        if not fused:
            carry["kernel_grads"] = {k: v.cpu() for k, v in g.items() if v is not None}
            carry["kernel_loss"] = loss_k
        del g
    set_fused_flags(fa, fm, False)
    del ref
    grad_s = time.perf_counter() - t0
    worst = {}
    for name in ("kernels_default", "kernels_fused"):
        bad = [(k, e, errs["plain_bf16"][k]) for k, e in errs[name].items()
               if not e <= GRAD_FACTOR * errs["plain_bf16"][k] + GRAD_FLOOR]
        if bad:
            fail(f"train {name}: {len(bad)} leaves' gradients farther from the fp32 step than "
                 f"{GRAD_FACTOR}x the bf16 plain route's + {GRAD_FLOOR}: {bad[:5]}")
        ratio = max(errs[name].items(), key=lambda kv: kv[1] / (errs["plain_bf16"][kv[0]] + GRAD_FLOOR))
        worst[name] = {"leaf": ratio[0], "rel_err": ratio[1], "plain_rel_err": errs["plain_bf16"][ratio[0]]}
    summary = {name: {"median": float(sorted(e.values())[len(e) // 2]), "max": max(e.values()),
                      "leaves": len(e)} for name, e in errs.items()}
    print(f"train gradients vs an fp32 plain-route step (loss {loss32:.6f}), relative L2 per leaf: "
          f"{json.dumps(summary)}; worst kernel leaf against bound {GRAD_FACTOR}x plain + {GRAD_FLOOR}: "
          f"{json.dumps(worst)}; {grad_s:.1f} s", flush=True)

    # the steps: default configuration, then fused, each from the seeded
    # parameters and a fresh optimizer, on the same batch
    runs, peak, step, trace = [], {}, None, None
    for phase, fused in (("default", False), ("fused", True)):
        if fused:
            del params, opt, step
            gc.collect()
            params, opt = tc.init_train_state(cfg, learning_rate=TRAIN_LR, seed=10)
        torch.cuda.reset_peak_memory_stats()
        step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16)
        timer = StepTimer(tc, opt)
        try:
            set_fused_flags(fa, fm, fused)
            for i in range(TRAIN_STEPS):
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timer.start()
                metrics = step(params, images, tokens)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = {n: c.launches for n, c in counters.items()}
                if launches != expect[fused]:
                    fail(f"train {phase} step {i}: launches {launches} != {expect[fused]}: a block "
                         "bypassed its kernel")
                loss = metrics["loss"].item()
                if not math.isfinite(loss):
                    fail(f"train {phase} step {i}: loss {loss}")
                runs.append({"config": phase, "step": i, "loss": loss, "accuracy": metrics["accuracy"].item(),
                             "wall_ms": wall, "ms": timer.read(), "launches": launches})
        finally:
            timer.restore()
            set_fused_flags(fa, fm, False)
        peak[phase] = torch.cuda.max_memory_allocated()
        if not fused:  # one more step, under the profiler: the device's share of a step
            trace = profile_step(lambda: step(params, images, tokens))
            print(f"train default profiled step: wall {trace['wall_ms']:.1f} ms, device busy "
                  f"{trace['busy_ms']:.1f} ms (idle share {trace['idle_share']:.3f}), {trace['kernels']} CUDA "
                  f"kernels; top by device µs: {json.dumps(trace['top'])}", flush=True)
        losses = [r["loss"] for r in runs if r["config"] == phase]
        print(f"train {phase}: losses {losses}", flush=True)
        if not losses[-1] < losses[0]:
            fail(f"train {phase}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    flops = train_flops(cfg, TRAIN_B)
    b_ms = flops / PEAK_BF16_FLOP_S * 1e3
    # bytes the step must move at least: the fp32 masters read, gradients
    # written and read, AdamW's two moments read and written, the masters
    # written (activations and weight casts not counted)
    by_ms = 7 * 4 * n_params / PEAK_BYTES_S * 1e3
    steady = {}
    for phase in ("default", "fused"):
        later = [r for r in runs if r["config"] == phase][1:]  # the first step of each warms up
        ms = {part: sum(r["ms"][part] for r in later) / len(later) for part in ("forward", "backward", "optimizer")}
        wall = sum(r["wall_ms"] for r in later) / len(later)
        steady[phase] = {"ms": ms, "wall_ms": wall, "pairs_per_s": TRAIN_B * 1e3 / wall,
                         "pct_of_bound": 100.0 * max(b_ms, by_ms) / wall}
    for r in runs:
        print(f"train {r['config']} step {r['step']}: loss {r['loss']:.6f} accuracy {r['accuracy']:.4f}; "
              f"wall {r['wall_ms']:.1f} ms (forward {r['ms']['forward']:.1f}, backward "
              f"{r['ms']['backward']:.1f}, optimizer {r['ms']['optimizer']:.1f}); launches {r['launches']}",
              flush=True)
    for phase, st in steady.items():
        print(f"train {phase}: {st['wall_ms']:.1f} ms a step of {TRAIN_B} pairs (forward "
              f"{st['ms']['forward']:.1f}, backward {st['ms']['backward']:.1f}, optimizer "
              f"{st['ms']['optimizer']:.1f}), {st['pairs_per_s']:.1f} pairs/s; bound {max(b_ms, by_ms):.2f} ms "
              f"({flops / 1e12:.2f} TFLOP at 989 TF/s bf16 {b_ms:.2f} ms; bytes {by_ms:.2f} ms), "
              f"{st['pct_of_bound']:.1f} % of bound", flush=True)
    print(f"train: {n_params} fp32 parameters, init {init_s:.2f} s; max memory allocated over the steps "
          f"{ {k: round(v / 2**30, 2) for k, v in peak.items()} } GiB ({live_before / 2**30:.2f} GiB live "
          f"before the phase); fused vs default loss per step "
          f"{[b['loss'] - a['loss'] for a, b in zip(runs[:TRAIN_STEPS], runs[TRAIN_STEPS:])]}", flush=True)

    # the checkpoint round trip, and the next step's loss from it
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "imagebind_huge_train.pt")
        t0 = time.perf_counter()
        ck.save_params(path, params)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = ck.load_params(path, like=params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    live, back = ck.flatten_params(params), ck.flatten_params(loaded)
    differ = [k for k in live if not (back[k].dtype == live[k].dtype and torch.equal(back[k], live[k].detach()))]
    if list(back) != list(live) or differ:
        fail(f"train checkpoint: the loaded parameters differ from the saved ones: {differ[:5]}")
    with torch.no_grad():
        next_live = tc.contrastive_loss(params, images, tokens, cfg, torch.bfloat16)[0].item()
        next_loaded = tc.contrastive_loss(loaded, images, tokens, cfg, torch.bfloat16)[0].item()
    if next_live != next_loaded:
        fail(f"train checkpoint: next step's loss {next_loaded} from the loaded parameters, {next_live} live")
    print(f"train checkpoint: {nbytes / 1e9:.2f} GB saved in {save_s:.2f} s, loaded in {load_s:.2f} s, "
          f"every leaf equal; next step's loss {next_live:.6f} from both", flush=True)
    del loaded, live, back, params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    carry["plain_err"] = errs["plain_bf16"]
    carry["steady"] = steady
    carry["peak"] = peak
    return carry, {"params": n_params, "batch": TRAIN_B, "learning_rate": TRAIN_LR, "init_s": init_s, "trace": trace,
            "grad_rel_err": summary, "grad_worst": worst, "grad_loss_fp32": loss32, "grad_s": grad_s,
            "steps": runs, "steady": steady, "bound_ms": max(b_ms, by_ms), "flop_bound_ms": b_ms,
            "byte_bound_ms": by_ms, "tflop": flops / 1e12, "max_memory_allocated": peak,
            "live_before": live_before, "checkpoint": {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                                                       "next_loss": next_live},
            "launches": {"default": runs[0]["launches"], "fused": runs[TRAIN_STEPS]["launches"]}}


MESH_TRAIN_STEPS = 3  # steps of each mesh path
PP_MICRO = 2  # GPipe microbatches
PP_LOSS_TOL = 2e-3  # the pp step's first loss against the TP step's (tests/test_megatron.py:94)
ZERO1_ABS, ZERO1_REL = 3e-5, 1e-4  # ZeRO-1 against replicated moments (tests/test_parallel.py:398)
MOE_EXPERTS, MOE_LR = 4, 1e-4  # the JAX adapter state's default learning rate


def mesh_train_phase(fa, fm, counters, carry, card):
    """12. the training half of the parallel layer at full ImageBind-Huge
    width on a mesh of 4 shards on the card."""
    import gc

    import torch

    from hippomm_tpu_torch.models.imagebind.model import huge_config, init_imagebind
    from hippomm_tpu_torch.parallel import mesh as pm
    from hippomm_tpu_torch.train import checkpoint as ck
    from hippomm_tpu_torch.train import contrastive as tc

    gc.collect()
    torch.cuda.empty_cache()
    cfg = huge_config()
    images, tokens = carry["images"], carry["tokens"]
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = pm.make_mesh(4, model_parallel=TRAIN_MESH["model"], devices=[dev] * 4)
    if mesh.shape != TRAIN_MESH:
        fail(f"mesh train: mesh {mesh.shape}, not {TRAIN_MESH}")
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    vis, txt = cfg.vision.depth, cfg.text.depth
    # one K1 (K4) a vision block and one K2 (K3) a block of both towers, on
    # each of the dp·mp shards
    expect = {False: {"flash_mha": dp * mp * vis, "fused_mlp": dp * mp * (vis + txt),
                      "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0},
              True: {"flash_mha": 0, "fused_mlp": 0, "fused_ln_mlp_residual": dp * mp * (vis + txt),
                     "flash_mha_bthd": dp * mp * vis}}
    out = {"mesh": mesh.shape, "card": card, "batch": TRAIN_B, "learning_rate": TRAIN_LR, "launches": {}}
    print(f"mesh train: ImageBind-Huge on a mesh {mesh.shape} of 4 shards that all sit on one card "
          f"({card}): these times measure the cost of the split, not scaling", flush=True)

    def zero():
        for c in counters.values():
            c.launches = 0

    def read():
        return {n: c.launches for n, c in counters.items()}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    def timed_steps(name, step, state, timer, want, n=MESH_TRAIN_STEPS, after_first=None):
        """n steps, each: exact launches, a finite loss; the losses fall."""
        rows = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(n):
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.start()
            metrics = step(state, images, tokens)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = read()
            if launches != want:
                fail(f"mesh train {name} step {i}: launches {launches} != {want}: a shard bypassed its kernel")
            loss = metrics["loss"].item()
            if not math.isfinite(loss):
                fail(f"mesh train {name} step {i}: loss {loss}")
            row = {"step": i, "loss": loss, "wall_ms": wall, "ms": timer.read(), "launches": launches}
            row.update({k: v.item() for k, v in metrics.items() if k not in ("loss",)})
            rows.append(row)
            if i == 0 and after_first is not None:
                after_first()
        losses = [r["loss"] for r in rows]
        if not losses[-1] < losses[0]:
            fail(f"mesh train {name}: the loss did not fall over {n} steps: {losses}")
        later = rows[1:]
        ms = {part: sum(r["ms"][part] for r in later) / len(later) for part in ("forward", "backward", "optimizer")}
        wall = sum(r["wall_ms"] for r in later) / len(later)
        summary = {"steps": rows, "losses": losses, "ms": ms, "wall_ms": wall, "pairs_per_s": TRAIN_B * 1e3 / wall,
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
        one = carry["steady"]["default"]
        for r in rows:
            print(f"mesh train {name} step {r['step']}: loss {r['loss']:.6f}; wall {r['wall_ms']:.1f} ms (forward "
                  f"{r['ms']['forward']:.1f}, backward {r['ms']['backward']:.1f}, optimizer "
                  f"{r['ms']['optimizer']:.1f}); launches {r['launches']}", flush=True)
        print(f"mesh train {name}: {wall:.1f} ms a step of {TRAIN_B} pairs (forward {ms['forward']:.1f}, backward "
              f"{ms['backward']:.1f}, optimizer {ms['optimizer']:.1f}), {summary['pairs_per_s']:.1f} pairs/s, max "
              f"memory allocated {summary['max_memory_allocated'] / 2**30:.2f} GiB; phase 10's one-device step "
              f"{one['wall_ms']:.1f} ms (forward {one['ms']['forward']:.1f}, backward {one['ms']['backward']:.1f}, "
              f"optimizer {one['ms']['optimizer']:.1f}), {one['pairs_per_s']:.1f} pairs/s, "
              f"{carry['peak']['default'] / 2**30:.2f} GiB; {card}", flush=True)
        out["launches"][name] = rows[0]["launches"]
        return summary

    # (a) one TP step's gradients against phase 10's one-device kernel route
    set_fused_flags(fa, fm, False)
    t0 = time.perf_counter()
    params, opt = tc.init_train_state(cfg, learning_rate=TRAIN_LR, seed=10, mesh=mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    zero()
    metrics, grads = tc.mesh_loss_and_grads(params, images, tokens, cfg, mesh, torch.bfloat16)
    torch.cuda.synchronize()
    if read() != expect[False]:
        fail(f"mesh train gradients: launches {read()} != {expect[False]}")
    errs, bad = {}, []
    for k, leaf in ck.flatten_params(params).items():
        blocks = grads[k]
        ref = carry["kernel_grads"].get(k)
        if ref is None:  # the audio tower: outside the loss on both
            if any(g is not None for g in blocks.values()):
                fail(f"mesh train gradients: {k} has a gradient, the one-device step has none")
            continue
        g = torch.zeros(leaf.shape, device=dev)
        for (_, bidx), gb in blocks.items():
            g[leaf.block_slices(bidx)] += gb
        ref = ref.to(dev)
        errs[k] = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        lim = GRAD_FACTOR * carry["plain_err"][k] + GRAD_FLOOR
        if not errs[k] <= lim:
            bad.append((k, errs[k], lim))
    del grads, g, ref
    if bad:
        fail(f"mesh train gradients: {len(bad)} leaves farther from the one-device kernel route than "
             f"{GRAD_FACTOR}x the bf16 plain route's error + {GRAD_FLOOR}: {bad[:5]}")
    worst = max(errs, key=lambda k: errs[k] / (GRAD_FACTOR * carry["plain_err"][k] + GRAD_FLOOR))
    out["grads"] = {"loss": metrics["loss"].item(), "one_device_loss": carry["kernel_loss"],
                    "median_rel_err": sorted(errs.values())[len(errs) // 2], "max_rel_err": max(errs.values()),
                    "worst": {"leaf": worst, "rel_err": errs[worst], "plain_rel_err": carry["plain_err"][worst]},
                    "leaves": len(errs)}
    print(f"mesh train gradients (TP, gathered per leaf) vs phase 10's one-device kernel route: loss "
          f"{out['grads']['loss']:.6f} vs {carry['kernel_loss']:.6f}; relative L2 median "
          f"{out['grads']['median_rel_err']:.3g}, max {out['grads']['max_rel_err']:.3g} over {len(errs)} leaves; "
          f"worst against bound {GRAD_FACTOR}x plain + {GRAD_FLOOR}: {json.dumps(out['grads']['worst'])}",
          flush=True)
    del params, opt, metrics
    fresh()

    # (b) the TP step, default then fused, each from the seeded parameters;
    # the default run's parameters after one step kept for (c)
    snapshot = {}
    for name, fused in (("tp_default", False), ("tp_fused", True)):
        params, opt = tc.init_train_state(cfg, learning_rate=TRAIN_LR, seed=10, mesh=mesh)
        step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16, mesh=mesh)
        timer = StepTimer(tc, opt, "contrastive_loss_mesh")

        def keep(params=params):
            snapshot.update({k: v.full(dev).detach().to("cpu", copy=True) for k, v in ck.flatten_params(params).items()})

        try:
            set_fused_flags(fa, fm, fused)
            out[name] = timed_steps(name, step, params, timer, expect[fused], after_first=None if fused else keep)
        finally:
            timer.restore()
            set_fused_flags(fa, fm, False)
        if not fused:
            out["moment_bytes"] = {"replicated": sum(b.numel() * 4 for m in opt.mu.values() for b in m.blocks.values())}
        del params, opt, step, timer
        fresh()

    # (c) ZeRO-1 against the replicated moments, one step
    params, opt = tc.init_train_state(cfg, learning_rate=TRAIN_LR, seed=10, mesh=mesh, zero1=True)
    step = tc.make_train_step(cfg, opt, dtype=torch.bfloat16, mesh=mesh)
    zero()
    loss = step(params, images, tokens)["loss"].item()
    torch.cuda.synchronize()
    if read() != expect[False]:
        fail(f"mesh train zero1: launches {read()} != {expect[False]}")
    worst, bad = 0.0, []
    for k, leaf in ck.flatten_params(params).items():
        want = snapshot[k].to(dev)
        diff = (leaf.full(dev).detach() - want).abs()
        if not bool((diff <= ZERO1_ABS + ZERO1_REL * want.abs()).all()):
            bad.append((k, diff.max().item()))
        worst = max(worst, diff.max().item())
    if bad:
        fail(f"mesh train zero1: {len(bad)} leaves beyond {ZERO1_ABS} + {ZERO1_REL}·|p| of the replicated step: "
             f"{bad[:5]}")
    positions = pm.positions(mesh)
    per_pos = [sum(m.local(pos).numel() * 4 for m in opt.mu.values()) for pos in positions]
    whole = sum(math.prod(m.shape) * 4 for m in opt.mu.values())
    split = sum(1 for m in opt.mu.values() if "data" in m.spec)
    out["zero1"] = {"loss": loss, "max_abs_diff": worst, "first_default_loss": out["tp_default"]["losses"][0],
                    "mu_bytes_per_position": per_pos, "mu_bytes_whole": whole,
                    "leaves_split_over_data": split, "leaves": len(opt.mu)}
    out["launches"]["zero1"] = read()
    print(f"mesh train zero1: one step's loss {loss:.6f} (replicated {out['tp_default']['losses'][0]:.6f}); "
          f"parameters within {worst:.3g} of the replicated-moment step (bound {ZERO1_ABS} + {ZERO1_REL}·|p|); "
          f"{split} of {len(opt.mu)} moment leaves split over data; each position's mu shards hold "
          f"{[round(b / 2**30, 3) for b in per_pos]} GiB of the whole {whole / 2**30:.3f} GiB (nu the same)",
          flush=True)
    del params, opt, step, snapshot
    fresh()

    # (d) GPipe on (data 1, pipe 2, model 2)
    mesh3 = pm.make_mesh(4, model_parallel=2, pipeline_parallel=2, devices=[dev] * 4)
    d3, s3, m3 = mesh3.shape["data"], mesh3.shape["pipe"], mesh3.shape["model"]
    ticks = PP_MICRO + s3 - 1
    # every stage runs its depth/S blocks on every tick, on each data × model
    # shard; the text tower tensor-parallel over the data shards' model ranks
    want_pp = {"flash_mha": ticks * vis * m3 * d3, "fused_mlp": ticks * vis * m3 * d3 + d3 * m3 * txt,
               "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}
    state, opt = tc.init_train_state_pp(cfg, mesh3, learning_rate=TRAIN_LR, seed=10)
    step = tc.make_train_step_pp(cfg, mesh3, opt, n_micro=PP_MICRO, dtype=torch.bfloat16)
    timer = StepTimer(tc, opt, "contrastive_loss_pp")
    try:
        out["pp"] = timed_steps("pp", step, state, timer, want_pp)
    finally:
        timer.restore()
    first = out["tp_default"]["losses"][0]
    if not abs(out["pp"]["losses"][0] - first) <= PP_LOSS_TOL:
        fail(f"mesh train pp: first loss {out['pp']['losses'][0]} not within {PP_LOSS_TOL} of the TP step's {first}")
    print(f"mesh train pp: mesh {mesh3.shape}, {PP_MICRO} microbatches, {ticks} ticks; first loss "
          f"{out['pp']['losses'][0]:.6f} vs the TP step's {first:.6f} (bound {PP_LOSS_TOL})", flush=True)
    del state, opt, step, timer
    fresh()

    # (e) the Switch-MoE adapter over the frozen towers
    frozen = init_imagebind(cfg, dev, dtype=torch.bfloat16, seed=10)
    moe, opt = tc.init_moe_adapter_state(cfg, mesh, n_experts=MOE_EXPERTS, learning_rate=MOE_LR, seed=11)
    step = tc.make_train_step_moe(frozen, cfg, mesh, opt, dtype=torch.bfloat16)
    want_moe = {"flash_mha": dp * vis, "fused_mlp": dp * (vis + txt), "fused_ln_mlp_residual": 0,
                "flash_mha_bthd": 0}  # the frozen towers, data-parallel
    timer = StepTimer(tc, opt, "info_nce")
    try:
        out["moe"] = timed_steps("moe", step, moe, timer, want_moe)
    finally:
        timer.restore()
    if not all(math.isfinite(r["balance"]) for r in out["moe"]["steps"]):
        fail(f"mesh train moe: balance aux {[r['balance'] for r in out['moe']['steps']]}")
    print(f"mesh train moe: {MOE_EXPERTS} experts over model {mp}; balance aux "
          f"{[round(r['balance'], 4) for r in out['moe']['steps']]}; tokens past capacity "
          f"{[int(r['dropped']) for r in out['moe']['steps']]} of {TRAIN_B} a step", flush=True)
    del frozen, moe, opt, step, timer
    fresh()

    # (f) save_params -> load_params(shardings=): every block its leaf's slice
    base = init_imagebind(cfg, dev, dtype=torch.float32, seed=10)
    specs = pm.param_shardings(base, mesh)
    params = pm.shard_tree(base, specs, mesh)
    del base
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "imagebind_huge_sharded.pt")
        t0 = time.perf_counter()
        ck.save_params(path, params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = ck.load_params(path, shardings=specs, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        saved = torch.load(path, map_location="cpu", weights_only=True)
    blocks, differ = 0, []
    for k, leaf in ck.flatten_params(loaded).items():
        whole = saved[k].to(dev)
        for (_, bidx), t in leaf.blocks.items():
            blocks += 1
            if not torch.equal(t, whole[leaf.block_slices(bidx)]):
                differ.append(k)
    if differ:
        fail(f"mesh train checkpoint: blocks differ from their leaf's slice: {differ[:5]}")
    out["checkpoint"] = {"save_s": save_s, "load_s": load_s, "blocks": blocks}
    print(f"mesh train checkpoint: saved in {save_s:.2f} s, loaded into {blocks} blocks by the specs in "
          f"{load_s:.2f} s, every block equal to its leaf's slice", flush=True)
    del params, loaded, saved
    fresh()
    return out


F32_FEATURE_TOL, F32_FEATURE_COS = 1e-3, 0.99999  # fp32 kernels vs fp32 plain, of max |feature|
F32_BF16_COS = 0.999  # fp32 features vs phase 4/5's bf16 ones
F32_GRAD_TOL = 1e-3  # fp32 kernel step vs fp32 plain step, relative L2 per leaf


def _reset_counts(counters):
    for c in counters.values():
        c.launches = 0
        c.launches_f32 = 0


def _min_cosine(a, b):
    import numpy as np

    return float((np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())


def fp32_phase(cfg, clip, bf16_features, counters, fa, fm):
    """13. the fp32 paths (see the module doc): (a) the ingest with
    models.compute_dtype float32, (b) a contrastive training step and 3
    steps in fp32, (c) the multi-device dry run, which trains in fp32."""
    import gc

    import numpy as np
    import torch

    from hippomm_tpu_torch import graft_entry
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.models.imagebind.model import huge_config
    from hippomm_tpu_torch.train import contrastive as tc

    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    def routed_out(fn):
        """fn() with the kernels' shape gates shut: the plain route."""
        gates = (layers.flash_supported, layers.fused_mlp_supported, fa.bthd_supported)
        layers.flash_supported = layers.fused_mlp_supported = fa.bthd_supported = lambda *a: False
        try:
            return fn()
        finally:
            layers.flash_supported, layers.fused_mlp_supported, fa.bthd_supported = gates

    # (a) the ingest at full width with ImageBind in fp32 (the engine builds
    # Whisper in bf16 whatever compute_dtype says, as the JAX engine does)
    cfg32 = copy.deepcopy(cfg)
    cfg32.models.compute_dtype = "float32"
    runs, feats = {}, {}
    with tempfile.TemporaryDirectory() as store_dir:
        cfg32.storage.base_dir = store_dir
        t0 = time.perf_counter()
        mem = HippocampalMemory(cfg32)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ib, wcfg = mem.imagebind, mem.whisper.cfg
        if ib.dtype != torch.float32 or ib.params["vision"]["blocks"][0]["mlp"]["fc1"]["weight"].dtype != torch.float32:
            fail("fp32 ingest: the engine did not build ImageBind in fp32")
        wh_blocks = math.ceil(math.ceil(len(clip.audio) / (30 * 16000)) / 32) * wcfg.encoder_layers
        for name, fused, plain in (("default", False, False), ("fused", True, False), ("plain", False, True)):
            vid = f"clip32_{name}"
            set_fused_flags(fa, fm, fused)
            _reset_counts(counters)
            before = dict(mem.timers.totals)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                run = lambda: mem.process_sequence(  # noqa: E731
                    vid, frame_paths=[f"frames/{vid}/{i:05d}.jpg" for i in range(len(clip.frames))],
                    frame_times=clip.frame_times, frames_rgb=clip.frames, audio_data=clip.audio)
                stms = routed_out(run) if plain else run()
                torch.cuda.synchronize()
            finally:
                set_fused_flags(fa, fm, False)
            wall = time.perf_counter() - t0
            launches = {n: c.launches for n, c in counters.items()}
            launches_f32 = {n: c.launches_f32 for n, c in counters.items()}
            expect, n_frames, n_vis_chunks, n_aud = ingest_expect(stms, ib.cfg, wh_blocks, fused)
            expect_f32 = ingest_expect(stms, ib.cfg, 0, fused)[0]
            if plain:  # every gate shut, Whisper's too
                expect = expect_f32 = dict.fromkeys(expect, 0)
            stages = {k: v - before.get(k, 0.0) for k, v in mem.timers.totals.items()}
            print(f"fp32 ingest {name}: {len(stms)} segments, {n_frames} frames in {n_vis_chunks} vision chunks, "
                  f"{n_aud} audio segments; launches {launches} (expected {expect}), fp32 {launches_f32} "
                  f"(expected {expect_f32}); wall {wall:.2f} s; stages "
                  f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}", flush=True)
            if launches != expect or launches_f32 != expect_f32:
                fail(f"fp32 ingest {name}: launches {launches}, fp32 {launches_f32}: not {expect}, {expect_f32}")
            feats[name] = {mod: np.concatenate([s.features[mod] for s in stms if mod in s.features])
                           for mod in ("vision", "audio")}
            runs[name] = {"wall_s": wall, "stages_s": stages, "segments": len(stms), "frames": n_frames,
                          "launches": launches, "launches_f32": launches_f32}
        del mem, ib
    agree = {}
    for name in ("default", "fused"):
        for mod in ("vision", "audio"):
            a, b, b16 = feats[name][mod], feats["plain"][mod], bf16_features[name][mod]
            if not a.shape == b.shape == b16.shape:
                fail(f"fp32 ingest {name} {mod}: features {a.shape}, plain {b.shape}, bf16 {b16.shape}")
            err = float(np.abs(a - b).max() / np.abs(b).max())
            cos, cos16 = _min_cosine(a, b), _min_cosine(a, b16)
            agree[f"{name}_{mod}"] = {"rel_max_abs_err": err, "min_cosine": cos, "min_cosine_vs_bf16": cos16}
            print(f"fp32 ingest {name} {mod}: vs the kernels routed out max abs {err:.3g} of max |feature| "
                  f"(limit {F32_FEATURE_TOL}), min cosine {cos:.7f} (limit {F32_FEATURE_COS}); vs phase "
                  f"{'5' if name == 'fused' else '4'}'s bf16 features min cosine {cos16:.6f} (limit "
                  f"{F32_BF16_COS})", flush=True)
            if not (math.isfinite(err) and err <= F32_FEATURE_TOL and cos >= F32_FEATURE_COS):
                fail(f"fp32 ingest {name} {mod}: kernels vs plain {err}, cos {cos}")
            if not cos16 >= F32_BF16_COS:
                fail(f"fp32 ingest {name} {mod}: vs bf16 features cos {cos16}")
    out["ingest"] = {"init_s": init_s, "runs": runs, "agree": agree, "media_s": float(len(clip.audio) / 16000)}
    del feats
    gc.collect()
    torch.cuda.empty_cache()

    # (b) training in fp32 through the kernels (K1/K2) at full width
    hcfg = huge_config()
    params, opt = tc.init_train_state(hcfg, learning_rate=TRAIN_LR, seed=10)
    images, tokens = train_batch(hcfg)
    vis, txt = hcfg.vision.depth, hcfg.text.depth
    expect = {"flash_mha": vis, "fused_mlp": vis + txt, "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}
    _reset_counts(counters)
    t0 = time.perf_counter()
    loss_k, gk = tc.loss_and_grads(params, images, tokens, hcfg, torch.float32)
    launched = {n: c.launches_f32 for n, c in counters.items()}
    if launched != expect:
        fail(f"fp32 train: the gradient step launched {launched} fp32 kernels, not {expect}")
    loss_p, gp = routed_out(lambda: tc.loss_and_grads(params, images, tokens, hcfg, torch.float32))
    errs = {k: ((gk[k] - r).norm() / r.norm().clamp_min(1e-30)).item() for k, r in gp.items() if r is not None}
    grad_s = time.perf_counter() - t0
    del gk, gp
    worst = max(errs.items(), key=lambda kv: kv[1])
    med = float(sorted(errs.values())[len(errs) // 2])
    print(f"fp32 train gradients through the kernels vs routed out: {len(errs)} leaves, relative L2 median "
          f"{med:.3g}, max {worst[1]:.3g} ({worst[0]}; limit {F32_GRAD_TOL}); losses "
          f"{float(loss_k['loss']):.7f} / {float(loss_p['loss']):.7f}; {grad_s:.1f} s", flush=True)
    if not worst[1] <= F32_GRAD_TOL:
        fail(f"fp32 train: {sum(e > F32_GRAD_TOL for e in errs.values())} leaves' gradients past "
             f"{F32_GRAD_TOL} of the plain fp32 step: worst {worst}")
    torch.cuda.reset_peak_memory_stats()
    step = tc.make_train_step(hcfg, opt, dtype=torch.float32)
    timer = StepTimer(tc, opt)
    steps = []
    try:
        for i in range(TRAIN_STEPS):
            _reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.start()
            metrics = step(params, images, tokens)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launched = {n: c.launches_f32 for n, c in counters.items()}
            loss = metrics["loss"].item()
            if launched != expect or not math.isfinite(loss):
                fail(f"fp32 train step {i}: fp32 launches {launched} (expected {expect}), loss {loss}")
            steps.append({"step": i, "loss": loss, "wall_ms": wall, "ms": timer.read(), "launches_f32": launched})
            print(f"fp32 train step {i}: loss {loss:.6f}; wall {wall:.1f} ms (forward "
                  f"{steps[-1]['ms']['forward']:.1f}, backward {steps[-1]['ms']['backward']:.1f}, optimizer "
                  f"{steps[-1]['ms']['optimizer']:.1f}); fp32 launches {launched}", flush=True)
    finally:
        timer.restore()
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in steps]
    print(f"fp32 train: losses {losses}; max memory allocated {peak / 2**30:.2f} GiB", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"fp32 train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    out["train"] = {"grad_rel_err": {"median": med, "max": worst[1], "leaf": worst[0], "leaves": len(errs)},
                    "steps": steps, "max_memory_allocated": peak, "launches": steps[0]["launches_f32"]}
    del params, opt, step, images, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the dry run on a mesh of 4 shards on the card, in fp32
    _reset_counts(counters)
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    launched = {n: c.launches_f32 for n, c in counters.items()}
    print(f"fp32 dry run: {dry['line']}; {dry_s:.1f} s; fp32 launches {launched}", flush=True)
    if sum(launched.values()) == 0 or sum(c.launches for c in counters.values()) != sum(launched.values()):
        fail(f"fp32 dry run: fp32 launches {launched}, all launches "
             f"{ {n: c.launches for n, c in counters.items()} }: not every one an fp32 kernel's")
    out["dryrun"] = {"line": dry["line"], "s": dry_s, "launches_f32": launched,
                     **{k: v for k, v in dry.items() if k.endswith("loss")}}
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


def ingest_blocks(spies, mem, vids, vis_depth: int, aud_depth: int, wh_depth: int = WHISPER_DEPTH):
    """Each ingested video's encoder blocks, from what the CLI spies saw:
    vision through the stream's 32-wide chunks (ceil(fed / 32) batches of
    vis_depth blocks), audio segments in 32-wide chunks of aud_depth blocks,
    and one Whisper encoder batch of `wh_depth` blocks per 32 ASR chunks of
    30 s (0 where an injected transcriber stands in for Whisper).
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
                  + enc_batches * wh_depth)
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


QA_FLOOR = 0.85  # the floor of the band the JAX bench calibrated caption noise 0.15 to (bench.py qa section)
QA_EXACT = ("count", "count_video", "summary", "video_neg", "audio_neg")  # clean ingest captions: exact
QA_FAMILIES = {"video", "audio", "multimodal", "summary", "count", "xmodal", "order", "after_tone",
               "which_video", "count_video", "video_neg", "audio_neg"}
QA_PARITY_QUESTIONS = 40  # (b)'s questions a pass
QA_PARITY_DIFFS = 2  # answer strings (b)'s routed-out pass may change (bf16 ties), verdicts never


class KernelShapes:
    """The shapes a path gives K1-K5, in phase 2's form (K1 (B, H, Tq, Tk,
    hd), K2 and K3 (N, D, F), K4 (B, T, H, hd), K5 (rows, D, k)): K1, K2 and
    K5's names at their call sites (models/layers, retrieval/search), and
    K3 and K4 at their wrappers' forward functions (the wrappers count their
    launches under their own module names, which stay), each replaced by a
    recorder that calls it."""

    def __init__(self):
        from hippomm_tpu_torch.models import layers
        from hippomm_tpu_torch.ops import flash_attention as fa
        from hippomm_tpu_torch.ops import fused_mlp as fm
        from hippomm_tpu_torch.retrieval import search

        self._saved = []
        sites = [
            (layers, "flash_mha", "flash_mha", lambda q, k, *r: (*q.shape[:3], k.shape[2], q.shape[3])),
            (layers, "fused_mlp", "fused_mlp", lambda x, w1, *r: (x.shape[0], x.shape[1], w1.shape[0])),
            (fm, "_fused_ln_mlp_residual_forward", "fused_ln_mlp_residual",
             lambda x, g, b, w1, *r: (x.shape[0], x.shape[1], w1.shape[0])),
            (fa, "_flash_mha_bthd_forward", "flash_mha_bthd", lambda q, *r: tuple(q.shape)),
            (search, "top_k_cosine_kernel", "top_k_cosine", lambda q, f, k, *r: (f.shape[0], f.shape[1], k)),
        ]
        self.seen = {name: set() for _, _, name, _ in sites}
        for obj, attr, name, key in sites:
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, fn))
            setattr(obj, attr, lambda *a, fn=fn, name=name, key=key, **k: self.seen[name].add(key(*a)) or fn(*a, **k))

    def restore(self):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)


def _qa_expect(ingest, spies):
    """K1-K5 launches of a harness run: the ingest's encoder blocks (K1 and
    K2 each), one K2 per text-tower block of each text forward, one K5 per
    single-question search round with k ≤ 128."""
    return {"flash_mha": ingest, "fused_mlp": ingest + TEXT_DEPTH * len(spies.text_rows),
            "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0,
            "top_k_cosine": sum(1 for k in spies.device_ks if k <= 128)}


def qa_phase(counters, fa, fm, ib_depths, card, checked):
    """14. the QA-accuracy harness (hippomm_tpu_torch/benchmarks/qa_harness)
    on the card at ImageBind-Huge width: (a) run_harness at bench config
    #5's shape over Y4M + WAV, its gates on the answers; (b) one ingest, then
    the same questions at caption noise 0 with the kernels and with them
    routed out: equal verdicts, exact launches. The harness's times include
    QuerySpies' synchronize around each text forward and search (threads
    of the batched path wait on each other there, so no stage split is
    read). Every shape the phase gives
    K1-K5 must be one phase 2 checked (`checked`: name -> shapes)."""
    import gc

    import torch

    from hippomm_tpu_torch.benchmarks import qa_harness as qh
    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core.batch_process import process_video_folder
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem

    vis_depth, aud_depth = ib_depths
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    out = {}

    # (a) the harness itself, as a user runs it (bench.py:919-923's shape)
    shape = dict(duration=180.0, scene_seconds=15.0, n_questions=120, imagebind_variant="huge",
                 n_videos=3, negatives=True, caption_noise=0.15, distractors=True, seed=0,
                 container="y4m")
    spies, cli, shapes = QuerySpies(), CliSpies(), KernelShapes()
    seen = shapes.seen
    try:
        with tempfile.TemporaryDirectory() as work:
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = qh.run_harness(work, **shape)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            (mem,) = cli.engines
            if (mem.imagebind.cfg.vision.width, mem.imagebind.cfg.vision.depth, mem.imagebind.cfg.text.depth,
                    mem.imagebind.dtype) != (1280, vis_depth, TEXT_DEPTH, torch.bfloat16):
                fail("qa: run_harness did not build ImageBind-Huge in bf16")
            videos, ingest = ingest_blocks(cli, mem, [f"palette{v:02d}" for v in range(3)], vis_depth,
                                           aud_depth, wh_depth=0)
            expect = _qa_expect(ingest["flash_mha"], spies)
            rounds = (list(spies.rounds), list(spies.device_ks))
            del mem
    finally:
        spies.restore()
        cli.restore()
        shapes.restore()
    results = res.pop("results")
    by_type = res["accuracy_by_type"]
    print(f"qa: run_harness at ImageBind-Huge width over Y4M + WAV ({shape}) in {wall:.1f} s", flush=True)
    print(f"qa: qa_accuracy {res['qa_accuracy']:.4f} ci95 {[float(x) for x in res['ci95']]}, qa_accuracy_batched "
          f"{res['qa_accuracy_batched']:.4f}; accuracy_by_type {json.dumps(by_type)}", flush=True)
    print(f"qa: ingest_x {res['ingest_x']}, ingest_wall_s {res['ingest_wall_s']}, media_s {res['media_s']}, "
          f"recall_p50_ms {res['recall_p50_ms']}, batched_s_per_q {res['batched_s_per_q']}; {card}", flush=True)
    print(f"qa: launches {launches}, expected {expect} (videos {videos}; text forwards "
          f"{len(spies.text_rows)}, search rounds on the device {len(rounds[1])})", flush=True)
    for r in results:
        if not r["correct"]:
            print(f"qa MISS [{r['type']}] {r['q']} -> {r['answer']}", flush=True)
    if launches != expect or not all(launches[k] for k in ("flash_mha", "fused_mlp", "top_k_cosine")):
        fail(f"qa: kernel launches {launches} != {expect}, or K1, K2 or K5 never launched")
    if rounds[0] != rounds[1]:
        fail(f"qa: search rounds {rounds[0]} did not all run on the device ({rounds[1]})")
    if (res["failed_videos"], res["n_scenes"], res["n_questions"]) != (0, 36, 120):
        fail(f"qa: failed videos {res['failed_videos']}, {res['n_scenes']} scenes, {res['n_questions']} questions")
    if set(by_type) != QA_FAMILIES:
        fail(f"qa: families {sorted(by_type)}, not the 12")
    if not (res["qa_accuracy"] >= QA_FLOOR and res["qa_accuracy_batched"] >= QA_FLOOR):
        fail(f"qa: accuracy {res['qa_accuracy']}, batched {res['qa_accuracy_batched']}: below {QA_FLOOR}")
    wrong = {k: by_type[k] for k in QA_EXACT if by_type[k] != 1.0}
    if wrong:
        fail(f"qa: the families that rest on clean ingest captions read {wrong}, not 1.0")
    out["harness"] = dict(res, wall_s=wall, launches=launches, expected_launches=expect, videos=videos,
                          misses=[r for r in results if not r["correct"]])

    # (b) one ingest, then the same questions at noise 0 through the kernels
    # and with them routed out
    gc.collect()
    torch.cuda.empty_cache()
    spies, cli, shapes = QuerySpies(), CliSpies(), KernelShapes()
    saved = {k: os.environ.get(k) for k in ("HIPPOMM_FLASH_ATTN", "HIPPOMM_FUSED_MLP", "HIPPOMM_TOPK_ROUTE")}
    passes = {}
    try:
        with tempfile.TemporaryDirectory() as work:
            folder = os.path.join(work, "videos")
            os.makedirs(folder)
            t_v = qh.write_palette_video(os.path.join(folder, "palette00.y4m"), duration=180.0,
                                         scene_seconds=15.0, seed=0, container="y4m")
            truth = {"scenes": t_v["scenes"], "video_scenes": [t_v["scenes"]], "video_names": ["palette00"]}
            questions = qh.build_questions(truth, QA_PARITY_QUESTIONS, seed=0, negatives=True)
            cfg = Config()
            cfg.api.mode = "stub"
            cfg.models.imagebind_variant = "huge"
            cfg.models.imagebind_path = ""
            cfg.models.whisper_variant = "stub"
            cfg.storage.base_dir = os.path.join(work, "store")
            cfg.processing.keyframe_dedup_threshold = 0.999  # as run_harness sets it
            vlm = qh.OracleVLM(noise_colors=sorted({c for _, _, c, _ in t_v["scenes"]}), seed=0)
            mem = HippocampalMemory(config=cfg, models={"whisper": qh.OracleASR(), "frame_client": vlm,
                                                        "qwen": vlm})
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            stats = process_video_folder(folder, cfg.storage.base_dir, config=cfg, memory_system=mem,
                                         checkpoint_every=0)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            ingest_launches = {k: c.launches for k, c in counters.items()}
            videos, ingest = ingest_blocks(cli, mem, ["palette00"], vis_depth, aud_depth, wh_depth=0)
            n_scenes = len(truth["scenes"])
            print(f"qa parity: ingest of 180 s ({n_scenes} scenes) in {ingest_s:.2f} s; launches "
                  f"{ingest_launches}, expected {ingest} ({videos})", flush=True)
            if stats["failed"] or n_scenes != 12:
                fail(f"qa parity: ingest failed ({stats['errors']}) or {n_scenes} scenes")
            if {k: ingest_launches[k] for k in ingest} != ingest or ingest_launches["top_k_cosine"]:
                fail(f"qa parity: ingest launches {ingest_launches} != {ingest}")
            qa = QARecallSystem(mem, cfg, reasoning_client=qh.OracleReasoning())
            for name, env in (("kernels", {}), ("routed_out", {"HIPPOMM_FLASH_ATTN": "0",
                                                               "HIPPOMM_FUSED_MLP": "0",
                                                               "HIPPOMM_TOPK_ROUTE": "host"})):
                os.environ.update(env)
                set_fused_flags(fa, fm, False)  # re-reads the kill switches too
                spies.reset()
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                answers = [qa.answer_question(q["question"]).answer for q in questions]
                torch.cuda.synchronize()
                pass_s = time.perf_counter() - t0
                got = {k: c.launches for k, c in counters.items()}
                want = _qa_expect(0, spies) if name == "kernels" else dict.fromkeys(got, 0)
                verdicts = [bool(qh.score_answer(q, a, truth)) for q, a in zip(questions, answers)]
                passes[name] = {"answers": answers, "verdicts": verdicts, "launches": got,
                                "expected_launches": want, "s": pass_s, "text_forwards": len(spies.text_rows),
                                "search_rounds": len(spies.rounds)}
                print(f"qa parity {name}: {QA_PARITY_QUESTIONS} questions in {pass_s:.2f} s, accuracy "
                      f"{sum(verdicts) / len(verdicts):.4f}; launches {got}, expected {want}", flush=True)
                if got != want:
                    fail(f"qa parity {name}: kernel launches {got} != {want}")
                for k in env:
                    os.environ.pop(k)
            del mem, qa
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        set_fused_flags(fa, fm, False)
        spies.restore()
        cli.restore()
        shapes.restore()
    for name, got in shapes.seen.items():
        seen[name] |= got
    k, r = passes["kernels"], passes["routed_out"]
    diffs = [(q["question"], a, b) for q, a, b in zip(questions, k["answers"], r["answers"]) if a != b]
    flips = [q["question"] for q, a, b in zip(questions, k["verdicts"], r["verdicts"]) if a != b]
    for q, a, b in diffs:
        print(f"qa parity: answers differ: {q} -> kernels {a!r}, routed out {b!r}", flush=True)
    print(f"qa parity: {len(diffs)} answers differ (limit {QA_PARITY_DIFFS}), {len(flips)} verdicts differ "
          f"(limit 0)", flush=True)
    if flips or len(diffs) > QA_PARITY_DIFFS:
        fail(f"qa parity: {len(flips)} verdicts and {len(diffs)} answers differ between the kernel pass and "
             f"the routed-out pass")
    out["parity"] = {"ingest_s": ingest_s, "ingest_launches": ingest_launches, "videos": videos,
                     "passes": passes, "answer_diffs": diffs, "verdict_flips": flips}
    unchecked = {name: sorted(got - checked[name]) for name, got in seen.items() if got - checked[name]}
    print(f"qa: kernel shapes {({name: sorted(got) for name, got in seen.items()})}, every one checked in "
          f"phase 2: {not unchecked}", flush=True)
    if unchecked:
        fail(f"qa: shapes phase 2 did not check: {unchecked}")
    out["shapes"] = {name: sorted(got) for name, got in seen.items()}
    out["launches"] = launches  # (a)'s run: the path's launches
    out["phase_s"] = time.perf_counter() - started
    print(f"qa: phase 14 took {out['phase_s']:.1f} s", flush=True)
    return out


SURFACE_SEED = 15
SURFACE_SEGMENT_S = 4.0  # each PCM segment: 3 clips of 2 s sampled from it
SURFACE_RESIZE_FRAMES = 4  # (b)'s frames: each method also runs on the host's CPU
SURFACE_RESIZE_TOL = 1e-4  # (b): CUDA against the CPU, max abs
SURFACE_GRAD_TOL = 1e-3  # (d): remat against not, relative L2 per leaf
RESIZE_METHODS = ("nearest", "linear", "bilinear", "triangle", "cubic", "bicubic", "lanczos3", "lanczos5")


def surface_phase(counters, fa, fm, card, checked):
    """15. the port's public surface on the card at ImageBind-Huge bf16 width
    (random weights from a seed): (a) numpy frames, PCM and tokens through
    preprocess_vision → preprocess_audio_batch → extract_features, default
    and fused, each tower bit-equal to its own forward and within 2e-2 /
    cosine ≥ 0.999 of the routed-out pass, exact launches; (b) every
    resize_normalize method, antialiased or not, on CUDA against the CPU;
    (c) each array op given numpy with no device: on CUDA, bit-equal to the
    op given the CUDA tensor; (d) stacked_blocks(remat=True) against
    remat=False at vision width: outputs, gradients, launches, memory.
    Every shape the phase gives K1-K4 must be one phase 2 checked."""
    import gc

    import numpy as np
    import torch

    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.models.imagebind import extract_features, init_imagebind
    from hippomm_tpu_torch.models.imagebind import model as ib_model
    from hippomm_tpu_torch.models.imagebind.preprocess import (load_tokenizer, preprocess_audio_batch,
                                                               preprocess_vision)
    from hippomm_tpu_torch.ops import mel, resize, silence, ssim
    from hippomm_tpu_torch.parallel.mesh import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    out = {}
    cfg = ib_model.huge_config()
    params = init_imagebind(cfg, "cuda", torch.bfloat16, seed=SURFACE_SEED)
    rng = np.random.default_rng(SURFACE_SEED)
    frames = rng.integers(0, 256, (32, 360, 640, 3), dtype=np.uint8)
    pcms = [(0.1 * rng.standard_normal(int(SURFACE_SEGMENT_S * 16000))).astype(np.float32) for _ in range(32)]
    tokens = load_tokenizer(vocab_size=cfg.vocab_size, context_length=cfg.context_length)(BATCH_QS)
    vis, aud, txt = cfg.vision.depth, cfg.audio.depth, cfg.text.depth
    expect = {
        "default": {"flash_mha": vis + aud, "fused_mlp": vis + aud + txt, "fused_ln_mlp_residual": 0,
                    "flash_mha_bthd": 0},
        # the fused flags: every block's MLP half through K3, the vision
        # attention (H 16) through K4; the text attention is masked (plain)
        "fused": {"flash_mha": aud, "fused_mlp": 0, "fused_ln_mlp_residual": vis + aud + txt,
                  "flash_mha_bthd": vis},
        "routed_out": dict.fromkeys(counters, 0),
    }
    forwards = {"vision": ib_model.vision_forward, "audio": ib_model.audio_forward,
                "text": ib_model.text_forward}

    # (a) numpy in, through the surface a user calls, on the default device
    saved = {k: os.environ.get(k) for k in ("HIPPOMM_FLASH_ATTN", "HIPPOMM_FUSED_MLP")}
    shapes = KernelShapes()
    runs = {}
    try:
        for name, fused, env in (("default", False, {}), ("fused", True, {}),
                                 ("routed_out", False, {"HIPPOMM_FLASH_ATTN": "0", "HIPPOMM_FUSED_MLP": "0"})):
            os.environ.update(env)
            set_fused_flags(fa, fm, fused)  # re-reads the kill switches too
            _reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                x = preprocess_vision(frames)
                mels = preprocess_audio_batch(pcms)
                feats = extract_features(params, cfg, vision=x, audio=mels, text=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            inputs = {"vision": x, "audio": mels, "text": torch.as_tensor(tokens, device="cuda")}
            with torch.no_grad():
                own = {k: torch.equal(v, forwards[k](params, inputs[k], cfg, torch.bfloat16)) for k, v in feats.items()}
            print(f"surface {name}: preprocess_vision {tuple(x.shape)} on {x.device}, preprocess_audio_batch "
                  f"{tuple(mels.shape)} on {mels.device}, extract_features "
                  f"{ {k: tuple(v.shape) for k, v in feats.items()} } in {wall:.3f} s; launches {launches}, "
                  f"expected {expect[name]}; bit-equal to each tower's forward {own}", flush=True)
            if (x.device.type, mels.device.type) != ("cuda", "cuda") or tuple(x.shape) != (32, 3, 224, 224) \
                    or tuple(mels.shape) != (32, 3, 1, 128, 204):
                fail(f"surface {name}: the preprocessed inputs are {x.shape} on {x.device}, {mels.shape} on "
                     f"{mels.device}")
            if sorted(feats) != ["audio", "text", "vision"] or any(
                    tuple(v.shape) != (n, 1024) or not torch.isfinite(v).all()
                    for v, n in zip((feats["audio"], feats["text"], feats["vision"]), (32, len(BATCH_QS), 32))):
                fail(f"surface {name}: extract_features gave {({k: tuple(v.shape) for k, v in feats.items()})}")
            if not all(own.values()):
                fail(f"surface {name}: extract_features differs from the towers' own forwards: {own}")
            if launches != expect[name]:
                fail(f"surface {name}: kernel launches {launches} != {expect[name]}")
            runs[name] = {"wall_s": wall, "launches": launches, "feats": feats}
            for k in env:
                os.environ.pop(k)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        set_fused_flags(fa, fm, False)
        shapes.restore()
    # the towers' heads are unit rows, audio's ×20 and text's × exp(logit_scale)
    scale = {"vision": 1.0, "audio": cfg.audio_logit_scale, "text": math.exp(params["text"]["logit_scale"].item())}
    agree = {}
    for name in ("default", "fused"):
        for tower, got in runs[name]["feats"].items():
            a, b = (f.float() / scale[tower] for f in (got, runs["routed_out"]["feats"][tower]))
            err = (a - b).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
            agree[f"{name}_{tower}"] = {"max_abs_err": err, "min_cosine": cos}
            print(f"surface {name} {tower} vs routed out (÷{scale[tower]:.4g}): max abs {err:.3g} (limit 2e-2), "
                  f"min cosine {cos:.6f} (limit 0.999)", flush=True)
            if not (math.isfinite(err) and err <= 2e-2 and cos >= 0.999):
                fail(f"surface {name} {tower}: {err}, cos {cos} against the routed-out pass")
    unchecked = {n: sorted(got - checked[n]) for n, got in shapes.seen.items() if got - checked[n]}
    print(f"surface: kernel shapes {({n: sorted(got) for n, got in shapes.seen.items()})}, every one checked "
          f"in phase 2: {not unchecked}", flush=True)
    if unchecked:
        fail(f"surface: shapes phase 2 did not check: {unchecked}")
    out["extract"] = {name: {k: v for k, v in r.items() if k != "feats"} for name, r in runs.items()}
    out["extract"]["agree"] = agree
    out["shapes"] = {n: sorted(got) for n, got in shapes.seen.items()}

    # (b) every resize method, antialiased or not: CUDA against the CPU;
    # preprocess_vision against resize_normalize
    few = frames[:SURFACE_RESIZE_FRAMES]
    errs = {}
    for method in RESIZE_METHODS:
        for aa in (True, False):
            got = resize.resize_normalize(few, method=method, antialias=aa)
            want = resize.resize_normalize(few, method=method, antialias=aa, device="cpu")
            if got.device.type != "cuda":
                fail(f"surface: resize_normalize({method}) of an array stayed on {got.device}")
            errs[f"{method}_{'aa' if aa else 'plain'}"] = (got.cpu() - want).abs().max().item()
    worst = max(errs.items(), key=lambda kv: kv[1])
    same = torch.equal(preprocess_vision(frames), resize.resize_normalize(frames))
    print(f"surface resize_normalize: {len(errs)} methods × antialias on CUDA vs the CPU, max abs "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }, worst {worst[0]} {worst[1]:.3g} (limit "
          f"{SURFACE_RESIZE_TOL}); preprocess_vision bit-equal to resize_normalize: {same}", flush=True)
    if not (worst[1] <= SURFACE_RESIZE_TOL and same):
        fail(f"surface: resize_normalize on CUDA {worst} against the CPU, or preprocess_vision differs ({same})")
    out["resize"] = {"max_abs_err": errs, "preprocess_vision_equal": same}

    # (c) each array op given numpy with no device: on CUDA, bit-equal to
    # the op given the CUDA tensor
    crops = resize.resize_crop_u8(frames, cfg.image_size)
    gray = ssim.rgb_to_gray(resize.resize_frames(frames, 180, 320)).cpu().numpy()
    pcm = np.concatenate(pcms)
    clips = np.stack([p[:32000] for p in pcms] * 3)  # 96 clips of 2 s
    whisper_mel, fbank = mel.WhisperMel(n_mels=128), mel.KaldiFbank(num_mel_bins=128)
    ops = {
        "resize_frames": (lambda f: resize.resize_frames(f, 180, 320), (frames,)),
        "normalize_nchw": (resize.normalize_nchw, (crops,)),
        "resize_normalize": (resize.resize_normalize, (frames,)),
        "WhisperMel": (whisper_mel, (pcm[: 30 * 16000],)),
        "KaldiFbank": (fbank, (clips,)),
        "ssim_pairs": (ssim.ssim_pairs, (gray[:-1], gray[1:])),
        "rgb_to_gray": (ssim.rgb_to_gray, (frames,)),
        "frame_difference": (ssim.frame_difference, (gray[:-1], gray[1:])),
        "window_rms_db": (lambda p: silence.window_rms_db(p, 800, 800), (pcm,)),
    }
    placed = {}
    for name, (fn, args) in ops.items():
        got = fn(*args)
        want = fn(*(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args))
        placed[name] = {"device": str(got.device), "shape": list(got.shape), "equal": torch.equal(got, want)}
        if got.device.type != "cuda" or not placed[name]["equal"]:
            fail(f"surface: {name} of an array: {placed[name]}, not bit-equal on CUDA to the CUDA tensor's")
    print(f"surface: array ops with no device, each on CUDA and bit-equal to the CUDA tensor's: "
          f"{ {k: (v['device'], tuple(v['shape'])) for k, v in placed.items()} }", flush=True)
    out["array_ops"] = placed
    del runs, feats, x, mels, inputs, crops, gray, clips, whisper_mel, fbank
    gc.collect()
    torch.cuda.empty_cache()

    # (d) stacked_blocks(remat=True) against remat=False at vision width
    blocks = params["vision"]["blocks"]
    leaves = [leaf for pb in blocks for _, leaf in tree_leaves(pb)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SURFACE_SEED)
    x0 = torch.randn((TRAIN_B, cfg.vision_tokens, cfg.vision.width), generator=gen, device="cuda")
    remat = {}
    host_grads = None
    for on in (False, True):
        for leaf in leaves:
            leaf.grad = None
        xin = x0.clone().requires_grad_(True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(counters)
        t0 = time.perf_counter()
        y = layers.stacked_blocks(blocks, xin, cfg.vision.heads, eps=cfg.vision.eps, dtype=torch.bfloat16, remat=on)
        fwd = {k: c.launches for k, c in counters.items()}
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        grads = [xin.grad] + [leaf.grad for leaf in leaves]
        if any(g is None for g in grads):
            fail(f"surface remat={on}: {sum(g is None for g in grads)} leaves got no gradient")
        if not on:  # kept on the host, out of the remat run's memory
            y0, host_grads = y.detach().cpu(), [g.cpu() for g in grads]
        else:
            rel = []
            for g, h in zip(grads, host_grads):
                h = h.cuda()
                rel.append(((g - h).float().norm() / h.float().norm().clamp_min(1e-30)).item())
            equal = torch.equal(y.detach().cpu(), y0)
        remat[on] = {"launches": launches, "forward_launches": fwd, "max_memory_allocated": peak,
                     "allocated_before": base, "step_s": step_s}
        print(f"surface stacked_blocks(remat={on}) at vision width ({vis} blocks, {TRAIN_B} × {cfg.vision_tokens} "
              f"tokens, bf16): launches {launches} (forward {fwd}), max_memory_allocated {peak / 2**30:.3f} GiB "
              f"({base / 2**30:.3f} GiB before), forward + backward {step_s:.3f} s; {card}", flush=True)
        del y, grads
    del y0, host_grads, xin
    for leaf in leaves:
        leaf.grad = None
        leaf.requires_grad_(False)
    want_no = {"flash_mha": vis, "fused_mlp": vis, "fused_ln_mlp_residual": 0, "flash_mha_bthd": 0}
    want_re = {k: 2 * v for k, v in want_no.items()}
    worst = max(rel)
    print(f"surface remat: outputs bit-equal {equal}; gradients relative L2 max {worst:.3g} over {len(rel)} "
          f"leaves (limit {SURFACE_GRAD_TOL}); launches {remat[False]['launches']} / {remat[True]['launches']}, "
          f"expected {want_no} / {want_re} (the recompute's forward counted)", flush=True)
    if not (equal and worst <= SURFACE_GRAD_TOL):
        fail(f"surface remat: outputs equal {equal}, gradients relative L2 {worst}")
    if (remat[False]["launches"], remat[True]["launches"]) != (want_no, want_re) or \
            remat[True]["forward_launches"] != want_no:
        fail(f"surface remat: launches {remat[False]['launches']} / {remat[True]['launches']} (forward "
             f"{remat[True]['forward_launches']}), not {want_no} / {want_re}")
    out["remat"] = {str(k): v for k, v in remat.items()}
    out["remat"]["grad_rel_l2_max"] = worst
    del params, blocks, leaves
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - started
    print(f"surface: phase 15 took {out['phase_s']:.1f} s", flush=True)
    return out


VLM_SEED = 16
VLM_FRAMES = 40  # key frames of the caption call: one full ViT chunk and a part of one
VLM_VISION_GAP = 0.04  # relative L2 of an image-token row from the fp32 reference's (the cell's limit)


def vlm_phase(counters, fa, fm, card):
    """16. Kimi-VL-A3B-Instruct on the card at full width (random weights
    from a seed): (a) K2's tanh instance and K1 at the ViT chunk's shapes
    against their plain versions; (b) the engine with models.vlm_variant
    set captions VLM_FRAMES JPEG key frames in one call and writes one
    summary through the in-process model: exact K1/K2 launches, graph
    replays, one frame's image tokens against the fp32 reference."""
    import gc

    import numpy as np
    import torch

    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.media.io import jpeg_encode
    from hippomm_tpu_torch.memory.engine import CAPTION_PROMPT, HippocampalMemory
    from hippomm_tpu_torch.models.kimi_vl import reference as kref
    from hippomm_tpu_torch.models.kimi_vl.config import get_config
    from hippomm_tpu_torch.models.kimi_vl.model import hf_config
    from hippomm_tpu_torch.utils import timers as tracing

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    out = {"card": card}
    kc = get_config("kimi-vl-a3b-instruct")
    v = kc.vision
    n_patch = (364 // v.patch) * (644 // v.patch)  # a 640x360 frame padded to a multiple of 28 px
    gen = torch.Generator(device="cuda").manual_seed(VLM_SEED)

    # (a) the kernels at the ViT chunk the cell launches
    fpad = -(-v.mlp // 128) * 128
    shape = (kc.vision_chunk * n_patch, v.width, fpad)
    x, w1, b1, w2, b2 = mlp_operands(shape, gen, False)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, w1, b1, w2, b2, approximate="tanh")
    torch.cuda.synchronize()
    if fm.fused_mlp.launches - before != 1:
        fail(f"vlm: K2 tanh at {shape} launched {fm.fused_mlp.launches - before} times, not once")
    ref = fm.fused_mlp_ref(x, w1, b1, w2, b2, approximate="tanh")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not math.isfinite(rel) or rel > 2e-2:
        fail(f"vlm: K2 tanh {shape}: max abs err {err} is {rel:.3g} of max|out| > 2e-2")
    n, d, f = shape
    b_ms, b_by = bound(2 * (2 * n * d + 2 * d * f) + 4 * (f + d), 4 * n * d * f)
    ms = cuda_ms([lambda: fm.fused_mlp(x, w1, b1, w2, b2, approximate="tanh")], repeats=5)
    out["k2_tanh"] = {"shape": list(shape), "max_abs_err": err, "rel_err": rel, "ms": ms,
                      "plain_ms": cuda_ms([lambda: fm.fused_mlp_ref(x, w1, b1, w2, b2, approximate="tanh")],
                                          iters=3, warmup=1),
                      "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / ms}
    del x, w1, b1, w2, b2, got, ref
    out["k1"] = check_attention(fa, (kc.vision_chunk, v.heads, n_patch, n_patch, v.width // v.heads), gen)
    print(f"vlm: K2 tanh {shape} {ms:.3f} ms ({out['k2_tanh']['pct_of_bound']:.1f} % of bound), "
          f"K1 {out['k1']['ms']:.3f} ms", flush=True)

    # (b) the engine's captioner and summariser
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "stub"
    cfg.models.vlm_variant = "kimi-vl-a3b-instruct"
    cfg.storage.base_dir = tempfile.mkdtemp(prefix="smoke-vlm-")
    t0 = time.perf_counter()
    mem = HippocampalMemory(cfg, device="cuda")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    vlm = mem.vlm
    rng = np.random.default_rng(VLM_SEED)
    frames = []
    for _ in range(VLM_FRAMES):
        base = rng.integers(0, 256, (9, 16, 3)).astype(np.float32)
        im = np.kron(base, np.ones((40, 40, 1))) + rng.normal(0, 20, (360, 640, 3))
        frames.append(np.clip(im, 0, 255).astype(np.uint8))
    jpegs = [jpeg_encode(im) for im in frames]
    tracing.RING.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(counters)
    t0 = time.perf_counter()
    captions = mem.frame_client.caption_images(jpegs, CAPTION_PROMPT)
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    chunks = math.ceil(VLM_FRAMES / kc.vision_chunk)
    want = {k: 0 for k in counters}
    want.update(flash_mha=v.depth * chunks, fused_mlp=v.depth * chunks)
    if launches != want:
        fail(f"vlm: the caption call launched {launches}, not {want}")
    if len(captions) != VLM_FRAMES or not all(captions) or any(c.startswith("[Error") for c in captions):
        fail(f"vlm: {len(captions)} captions, some empty or placeholders: {captions[:3]}")
    loop = vlm.loops[-1]
    steps = [r for r in tracing.RING if r.name == "vlm.graph_steps"]
    if sum(r.n for r in steps) != loop["steps"] or loop["steps"] < 1:
        fail(f"vlm: {sum(r.n for r in steps)} graph steps of {loop['steps']} decode steps")
    decode = sum((r.end_ns - r.start_ns) for r in tracing.RING if r.name == "vlm.decode" and r.n is None)
    out["caption"] = {"frames": VLM_FRAMES, "s": cap_s, "launches": launches, "rows": loop["rows"],
                      "steps": loop["steps"], "decode_ms_per_step": decode / 1e6 / max(1, loop["steps"]),
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    _reset_counts(counters)
    t0 = time.perf_counter()
    summary = mem.qwen.generate("Summarize these scene descriptions:\n" + "\n".join(captions), max_tokens=128)
    torch.cuda.synchronize()
    sum_launches = {k: c.launches for k, c in counters.items()}
    if any(sum_launches.values()) or not summary:
        fail(f"vlm: the summary launched {sum_launches} (want none) and wrote {len(summary)} characters")
    out["summary"] = {"s": time.perf_counter() - t0, "launches": sum_launches,
                      "prompt_tokens": vlm.loops[-1]["lengths"][0]}
    # one frame's image tokens against the plain fp32 reference
    rows = vlm.encode_images(frames[:1])[0].float()
    pix = vlm.pixels(frames[:1])
    want_rows = kref.vision_forward(vlm.params, hf_config(kc), pix)[0]
    gap = ((rows - want_rows).norm(dim=1) / want_rows.norm(dim=1).clamp(min=1e-12)).max().item()
    if not math.isfinite(gap) or gap > VLM_VISION_GAP:
        fail(f"vlm: image tokens {gap:.4f} relative L2 from the fp32 reference > {VLM_VISION_GAP}")
    out["vision_gap"] = gap
    out["graph_bytes"] = vlm.graph_bytes()
    out["wall_s"] = time.perf_counter() - started
    print(f"vlm: caption call {cap_s:.2f} s ({loop['rows']} rows, {loop['steps']} steps, "
          f"{out['caption']['decode_ms_per_step']:.2f} ms a step), summary {out['summary']['s']:.2f} s "
          f"({out['summary']['prompt_tokens']} prompt tokens), image tokens {gap:.4f} from the reference, "
          f"peak {out['caption']['peak_bytes'] / 1e9:.1f} GB; {card}", flush=True)
    del mem, vlm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "hippomm_tpu_torch")):
        fail("no hippomm_tpu_torch package beside this script (run it from a checkout)", 2)
    sys.path.insert(0, HERE)
    started = time.perf_counter()
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
        # ... and the training step's vision tower (16 pairs)
        # ... and on one of phase 11's 4 shards (SHARD_SHAPES), and of phase
        # 12's (TRAIN_SHARD_SHAPES)
        "flash_mha": [check_attention(fa, s, gen) for s in (
            (32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64),
            (16, 16, 257, 257, 80)) + SHARD_SHAPES["flash_mha"] + TRAIN_SHARD_SHAPES["flash_mha"]],
        # ... and the text tower: one question (77 rows), a batch of 8 (616)
        # ... and the training step's towers (16 pairs: 4112 vision rows,
        # 1232 text rows); then the shard shapes
        "fused_mlp": [check_mlp_kernel(fm, s, gen, False) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120), (77, 1024, 4096),
            (616, 1024, 4096), (4112, 1280, 5120), (1232, 1024, 4096)) + SHARD_SHAPES["fused_mlp"]
            + TRAIN_SHARD_SHAPES["fused_mlp"] + QA_SHAPES["fused_mlp"]],
        "fused_ln_mlp_residual": [check_mlp_kernel(fm, s, gen, True) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (77, 1024, 4096), (616, 1024, 4096),
            (4112, 1280, 5120), (1232, 1024, 4096)) + SHARD_SHAPES["fused_ln_mlp_residual"]
            + TRAIN_SHARD_SHAPES["fused_ln_mlp_residual"]]
        + [check_mlp_kernel(fm, s, gen, True, residual=False) for s in TRAIN_SHARD_SHAPES["fused_ln_mlp_residual"]],
        "flash_mha_bthd": [check_attention_bthd(fa, s, gen) for s in (
            (32, 257, 16, 80), (16, 257, 16, 80)) + SHARD_SHAPES["flash_mha_bthd"]
            + TRAIN_SHARD_SHAPES["flash_mha_bthd"]],
        # the JAX package's store scale, search's first round, and 1e6 rows
        # at the kernel's k limit; then an ascending-sorted 2e5 store
        # (reported: the filter's worst case); then the shard shapes
        "top_k_cosine": [check_topk(ttk, s, gen) for s in (
            (200_000, 1024, 20), (200_000, 1024, 40), (1_000_000, 1024, 128))]
        + [check_topk(ttk, (200_000, 1024, 20), gen, ascending=True)]
        + [check_topk(ttk, s, gen) for s in SHARD_SHAPES["top_k_cosine"] + QA_SHAPES["top_k_cosine"]]
        # ... and rows of any width (D 6, 1026: the element-wise instance)
        # and a store view one element into its buffer
        + [check_topk(ttk, s, gen, offset=o) for s, o in (
            ((200_000, 6, 20), 0), ((200_000, 1026, 20), 0), ((200_000, 1024, 20), 1))],
        # the fp32 kernels (phase 13's paths, as the JAX package computes
        # them in fp32): K1 at the ingest, Whisper and training shapes
        "flash_mha_f32": [check_attention_f32(fa, s, gen, False) for s in (
            (32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64), (16, 16, 257, 257, 80))],
        # ... K2/K3 at the ingest, Whisper, text (1 and 8 questions) and
        # training shapes
        "fused_mlp_f32": [check_mlp_kernel(fm, s, gen, False, f32=True) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120), (77, 1024, 4096),
            (616, 1024, 4096), (4112, 1280, 5120), (1232, 1024, 4096))],
        "fused_ln_mlp_residual_f32": [check_mlp_kernel(fm, s, gen, True, residual=r, f32=True)
                                      for r in (True, False) for s in (
            (8224, 1280, 5120), (21984, 768, 3072), (77, 1024, 4096), (616, 1024, 4096),
            (4112, 1280, 5120), (1232, 1024, 4096))],
        # ... K4 on the vision tower's packed projection, ingest and training
        "flash_mha_bthd_f32": [check_attention_f32(fa, s, gen, True) for s in (
            (32, 257, 16, 80), (16, 257, 16, 80))],
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
            off = f" offset {r['offset']}" if r.get("offset") else ""
            # the fp32 rows: their bound is the 3×TF32 one; the fp32 one beside it
            fp32 = (f"; fp32 bound {r['fp32_bound_ms']:.4f} ms ({r['fp32_bound_by']}), "
                    f"{r['pct_of_fp32_bound']:.1f} % of it" if "fp32_bound_ms" in r else "")
            print(f"{name} {r['shape']}{' ascending' if r.get('ascending') else ''}{off}"
                  f"{' without residual' if r.get('residual') is False else ''}: "
                  f"err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms "
                  f"plain {r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['pct_of_bound']:.1f} % of "
                  f"bound{fp32}{extra}", flush=True)
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
        # (one shard: one device)
        decodes = []
        real_greedy = wt._graphs.decode

        def greedy_spy(*a, **k):
            out = real_greedy(*a, **k)
            decodes.append((torch.cat([t for t, _ in out]).cpu().numpy(),
                            torch.cat([ln for _, ln in out]).cpu().numpy()))
            return out

        wt._graphs.decode = greedy_spy
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
                expect, n_frames, n_vis_chunks, n_aud = ingest_expect(
                    stms, ib.cfg, enc_batches * wcfg.encoder_layers, fused)
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
            wt._graphs.decode = real_greedy
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
        # what phase 11 holds the mesh engine to: the one-device engine's
        # features, counts and times
        bucket = next(t for t in (4, 16, 32) if n_chunks <= t or t == 32)
        one_device = {ph: {"vision": np.concatenate([s.features["vision"] for s in v["stms"] if "vision" in s.features]),
                           "audio": np.concatenate([s.features["audio"] for s in v["stms"] if "audio" in s.features]),
                           "bucket": bucket, **{k: v[k] for k in ("wall_s", "stages_s", "segments", "frames",
                                                                  "audio_segments", "vision_chunks",
                                                                  "encoder_batches")}}
                      for ph, v in paths.items()}
        if enc_batches != 1:
            fail(f"phase 11 expects one Whisper encoder batch, the clip has {enc_batches}")
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

        # 7. search at a store of 200 000 rows
        report["search"], *search = search_phase(ttk)

        # 11. the data-parallel path on a mesh of 4 shards on the card, over
        # phase 4's clip, phase 7's store and phase 6's store
        report["mesh"] = mesh_phase(cfg, qcfg, clip, one_device, counters, fa, fm, ttk, search,
                                    report["query"]["runs"]["video"]["results"][0])
        del search

    # 9. the QA server from a checkpoint file, after the query phase (the
    # token counter's `transformers` import is paid)
    report["serve"] = serve_phase(dict(counters, top_k_cosine=ttk.top_k_cosine_kernel), depths)

    # 10. contrastive training at full ImageBind-Huge width
    carry, report["train"] = train_phase(fa, fm, counters)

    # 12. the training half of the parallel layer on a mesh of 4 shards on
    # the card, held to phase 10's one-device step
    report["mesh_train"] = mesh_train_phase(fa, fm, counters, carry, card)
    del carry

    # 13. the fp32 paths: the ingest with ImageBind in fp32 (held to phase
    # 4/5's bf16 features), fp32 training, the dry run
    report["fp32"] = fp32_phase(cfg, clip, one_device, counters, fa, fm)
    del one_device

    # 14. the QA-accuracy harness at ImageBind-Huge width: its answers gated
    checked = {name: {tuple(r["shape"]) for r in rows[name] if not r.get("ascending") and not r.get("offset")}
               for name in ("flash_mha", "fused_mlp", "fused_ln_mlp_residual", "flash_mha_bthd",
                            "top_k_cosine")}
    report["qa"] = qa_phase(dict(counters, top_k_cosine=ttk.top_k_cosine_kernel), fa, fm, depths, card, checked)

    # 15. the public surface: numpy inputs through preprocess_vision,
    # preprocess_audio_batch and extract_features, every resize method, the
    # array ops' placement, stacked_blocks(remat=True)
    report["surface"] = surface_phase(counters, fa, fm, card, checked)

    # 16. Kimi-VL: K2's tanh instance and K1 at the ViT chunk, then the
    # engine's in-process captioner and summariser
    report["vlm"] = vlm_phase(counters, fa, fm, card)

    sources = {"flash_mha": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "fused_mlp": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "fused_ln_mlp_residual": "hippomm_tpu_torch/csrc/fused_mlp.cu",
               "flash_mha_bthd": "hippomm_tpu_torch/csrc/flash_mha.cu",
               "top_k_cosine": "hippomm_tpu_torch/csrc/topk_cosine.cu",
               "flash_mha_f32": "hippomm_tpu_torch/csrc/flash_mha_f32.cu",
               "fused_mlp_f32": "hippomm_tpu_torch/csrc/fused_mlp_f32.cu",
               "fused_ln_mlp_residual_f32": "hippomm_tpu_torch/csrc/fused_mlp_f32.cu",
               "flash_mha_bthd_f32": "hippomm_tpu_torch/csrc/flash_mha_f32.cu"}
    replaces = {"flash_mha": "hippomm_tpu/ops/flash_attention.py:80",
                "fused_mlp": "hippomm_tpu/ops/fused_mlp.py:123",
                "fused_ln_mlp_residual": "hippomm_tpu/ops/fused_mlp.py:153",
                "flash_mha_bthd": "hippomm_tpu/ops/flash_attention.py:319",
                "top_k_cosine": "hippomm_tpu/ops/pallas_topk.py:46"}
    for name in ("flash_mha", "fused_mlp", "fused_ln_mlp_residual", "flash_mha_bthd"):
        replaces[f"{name}_f32"] = replaces[name]
    # launches per path, each read from counts set to 0 just before it
    by_path = {f"ingest_{ph}": paths[ph]["launches"] for ph in paths}
    by_path["cli"] = report["cli"]["launches"]
    by_path["query"] = report["query"]["launches"]  # the default-configuration questions
    by_path["query_fused"] = report["query"]["runs"]["video_fused"]["launches"]
    # the server's requests: both /ingest calls, then the questions
    serve_runs = list(report["serve"]["ingest"].values()) + list(report["serve"]["ask"].values())
    by_path["serve"] = {k: sum(r["launches"].get(k, 0) for r in serve_runs) for k in rows}
    # phase 11's mesh: both ingests, the 64 single searches, the question
    for ph in ("default", "fused"):
        by_path[f"mesh_{ph}"] = report["mesh"]["ingest"][ph]["launches"]
    by_path["mesh_search"] = {"top_k_cosine": report["mesh"]["search"]["k5_launches"]}
    by_path["mesh_query"] = report["mesh"]["query"]["launches"]
    # one training step in each configuration
    by_path["train_default"] = report["train"]["launches"]["default"]
    by_path["train_fused"] = report["train"]["launches"]["fused"]
    # phase 12: one step of each mesh path
    for name, counts in report["mesh_train"]["launches"].items():
        by_path[f"mesh_train_{name}"] = counts
    # phase 14: the harness run (ingest of 3 videos, 120 questions single
    # and batched), and (b)'s ingest with its kernel pass
    by_path["qa"] = report["qa"]["launches"]
    parity = report["qa"]["parity"]
    by_path["qa_parity"] = {k: v + parity["passes"]["kernels"]["launches"][k]
                            for k, v in parity["ingest_launches"].items()}
    # phase 15: extract_features over numpy inputs, default and fused
    for ph in ("default", "fused"):
        by_path[f"surface_{ph}"] = report["surface"]["extract"][ph]["launches"]
    # phase 16: the engine's caption call (MoonViT's K1 and K2 tanh)
    by_path["vlm_caption"] = report["vlm"]["caption"]["launches"]
    # the fp32 kernels' launches per phase-13 path, each read from counts
    # set to 0 just before it
    by_path_f32 = {f"fp32_ingest_{ph}": report["fp32"]["ingest"]["runs"][ph]["launches_f32"]
                   for ph in ("default", "fused")}
    by_path_f32["fp32_train"] = report["fp32"]["train"]["launches"]
    by_path_f32["fp32_dryrun"] = report["fp32"]["dryrun"]["launches_f32"]
    # each kernel's own path: K1/K2 the default ingest, K3/K4 the fused one,
    # K5 the query path; the fp32 kernels the same in phase 13
    own_path = {"flash_mha": "ingest_default", "fused_mlp": "ingest_default",
                "fused_ln_mlp_residual": "ingest_fused", "flash_mha_bthd": "ingest_fused",
                "top_k_cosine": "query"}
    kernels = []
    for name, rs in rows.items():
        head = rs[0]  # the first shape: vision tower (K1-K4), the JAX store scale (K5)
        base = name.removesuffix("_f32")
        paths_of = by_path_f32 if name != base else by_path
        own = own_path[base] if name == base else f"fp32_{own_path[base]}"
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": paths_of[own][base],
            "launches_by_path": {ph: counts.get(base, 0) for ph, counts in paths_of.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "pct_of_bound": head["pct_of_bound"], "shapes": rs,
        })
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - started
    print(f"chip_smoke: all phases in {report['wall_s']:.1f} s, the build included", flush=True)
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
