"""The ingest cells: folders of seeded videos through the port's ingest CLI
(`core/batch_process.process_video_folder`) with one engine built in
set-up, called on fresh folders until the window's seconds have passed.

What the window produced is then held against the plain reference (see
`check`): the key-frame walk and the segmentation of the persisted
events, their vision and audio embeddings, and the Whisper tokens the
engine decoded, on a sample of the completed videos drawn from the seed.
"""

from __future__ import annotations

import math
import os
import sys
import shutil
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import media, work
from portbench.harness.clients import StandIn
from portbench.harness.seeds import seed_words
from portbench.harness.trace import Traced
from portbench.harness.weights import imagebind_params, whisper_params

# the stages of each layer: StageTimer's, and the vision stream's worker
# (TowerCapture); extract_vision_feed, the hand-off of key frames to that
# stream, is nested in the extract_* stages and is charged to the towers
TOWER_WORKER = "vision_stream_worker"
EXTRACT = ("extract_decode", "extract_score", "extract_seg_ssim", "extract_jpeg_save")
ENGINE = ("segmentation", "consolidate", "caption", "summary", "checkpoint")
ENCODE = ("encode_vision", "encode_audio", "extract_vision_feed", TOWER_WORKER)
ATTN_KERNELS = ("flash_mha",)
MLP_KERNELS = ("gemm_tn", "gemm_tf32x3", "splitk_reduce", "layer_norm_rows", "split_rows_f32")
AUDIO_CHUNK, ASR_BATCH = 32, 32


class AsrCapture:
    """Keeps the token rows the engine's Whisper decodes, per video: the
    engine's `dispatch_asr` names the video, the transcriber's finisher
    runs the decode loops, and `_decode` returns each chunk batch's
    (tokens, lengths). Nothing the program computes is changed."""

    def __init__(self, mem):
        self.by_video: Dict[str, List] = {}
        tl = threading.local()
        impl = mem.whisper._impl
        orig_dispatch, orig_async, orig_decode = mem.dispatch_asr, impl.transcribe_many_async, impl._decode

        def dispatch(video_id, audio, sample_rate=16000):
            tl.vid = video_id
            try:
                return orig_dispatch(video_id, audio, sample_rate)
            finally:
                tl.vid = None

        def many_async(pcms, *a, **k):
            vid = getattr(tl, "vid", None)
            inner = orig_async(pcms, *a, **k)

            def finish():
                tl.rec = self.by_video.setdefault(vid, [])
                try:
                    return inner()
                finally:
                    tl.rec = None

            return finish

        def decode(shards, max_len):
            out = orig_decode(shards, max_len)
            rec = getattr(tl, "rec", None)
            if rec is not None:
                rec.append(list(out))
            return out

        mem.dispatch_asr, impl.transcribe_many_async, impl._decode = dispatch, many_async, decode

    def rows(self, video_id: str, n_chunks: int):
        """(tokens (n, max_len), lengths (n,)) of the video's real chunks."""
        toks, lens = [], []
        left = n_chunks
        for batch in self.by_video.get(video_id, []):
            t = torch.cat([x[0] for x in batch]).cpu().numpy()
            ln = torch.cat([x[1] for x in batch]).cpu().numpy()
            take = min(left, ASR_BATCH)
            toks.append(t[:take])
            lens.append(ln[:take])
            left -= take
        if not toks:
            return None, None
        return np.concatenate(toks), np.concatenate(lens)


class TowerCapture:
    """The vision tower's work as the run does it. The extraction hands key
    frames to the tower's `VisionEncodeStream`, whose worker thread resizes
    them and launches each chunk; no StageTimer stage holds that thread.
    This times its jobs (host seconds of the towers) and counts the real
    rows of every vision forward, streamed or not. Nothing the program
    computes is changed."""

    def __init__(self, ib):
        self.busy_s = 0.0
        self.rows: List[int] = []
        lock = threading.Lock()
        orig_stream, orig_encode = ib.vision_stream, ib.encode_vision

        def timed(fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    with lock:
                        self.busy_s += time.perf_counter() - t
            return run

        def stream():
            s = orig_stream()
            dispatch = s._dispatch

            def counted(chunk):
                self.rows.append(len(chunk))
                return dispatch(chunk)

            s._ingest, s._drain_remainder, s._dispatch = timed(s._ingest), timed(s._drain_remainder), counted
            return s

        def encode(frames):
            self.rows.append(len(frames))
            return orig_encode(frames)

        ib.vision_stream, ib.encode_vision = stream, encode


def port_config(cfg: Dict, store: str):
    from hippomm_tpu_torch.config import Config

    c = Config()
    c.api.mode = "stub"
    c.models.imagebind_variant = cfg["imagebind_variant"]
    c.models.whisper_variant = cfg["whisper_variant"]
    c.models.compute_dtype = cfg["imagebind_dtype"]
    c.models.whisper_beam_size = cfg["whisper_beam_size"]
    c.storage.base_dir = store
    return c


def build_engine(cfg: Dict, params_ib, params_wh, device, store: str):
    """The engine as the deployment builds it, with the benchmark's weights
    and the stand-in clients."""
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.models.foundation import ImageBind, Whisper

    ib = ImageBind(variant=cfg["imagebind_variant"], dtype=getattr(torch, cfg["imagebind_dtype"]),
                   device=device, params=params_ib)
    models = {"imagebind": ib, "qwen": StandIn(), "frame_client": StandIn()}
    if params_wh is not None:
        models["whisper"] = Whisper(model_name=cfg["whisper_variant"], variant=cfg["whisper_variant"],
                                    dtype=getattr(torch, cfg["whisper_dtype"]),
                                    beam_size=cfg["whisper_beam_size"], device=device,
                                    params=params_wh)
    return HippocampalMemory(port_config(cfg, store), models=models, device=device)


def check_port_config(cfg: Dict) -> None:
    """The port's own variants have the configuration file's sizes (the
    program builds its towers from the variant; the reference from the file)."""
    from hippomm_tpu_torch.models.imagebind import model as ibm
    from hippomm_tpu_torch.models.whisper import model as whm

    ic = ibm.get_config(cfg["imagebind_variant"])
    ib = cfg["imagebind"]
    got = {t: (getattr(ic, t).width, getattr(ic, t).depth, getattr(ic, t).heads, getattr(ic, t).mlp_ratio)
           for t in ("vision", "audio", "text")}
    got["model"] = (ic.image_size, ic.patch_size, ic.embed_dim, ic.vocab_size, ic.context_length)
    want = {t: (ib[t]["width"], ib[t]["depth"], ib[t]["heads"], ib[t]["mlp_ratio"])
            for t in ("vision", "audio", "text")}
    want["model"] = (ib["image_size"], ib["patch_size"], ib["embed_dim"], ib["vocab_size"],
                     ib["context_length"])
    wc = whm.get_config(cfg["whisper_variant"])
    w = cfg["whisper"]
    got["whisper"] = (wc.d_model, wc.encoder_layers, wc.decoder_layers, wc.heads, wc.ffn, wc.vocab_size,
                      wc.n_mels, wc.max_source_positions, wc.max_target_positions)
    want["whisper"] = (w["d_model"], w["encoder_layers"], w["decoder_layers"], w["encoder_attention_heads"],
                       w["encoder_ffn_dim"], w["vocab_size"], w["num_mel_bins"], w["max_source_positions"],
                       w["max_target_positions"])
    if got != want:
        raise ValueError(f"the port's variants differ from the configuration file: {got} != {want}")


def _link_folder(root: str, k: int, sources: List[Dict]) -> str:
    folder = os.path.join(root, f"folder{k:04d}")
    os.makedirs(folder)
    for i, s in enumerate(sources):
        stem = os.path.join(folder, f"c{k:04d}v{i}")
        os.symlink(s["y4m"], stem + ".y4m")
        os.symlink(s["wav"], stem + ".wav")
    return folder


def _timers(mem, towers) -> Dict[str, float]:
    out = dict(mem.timers.totals)
    if towers is not None:
        out[TOWER_WORKER] = towers.busy_s
    return out


def _delta(a: Dict[str, float], b: Dict[str, float], names) -> float:
    return sum(b.get(n, 0.0) - a.get(n, 0.0) for n in names)


def asr_chunks(cfg: Dict, spec) -> int:
    """The 30 s windows the transcriber cuts a track into."""
    n = int(round(spec.duration * spec.sample_rate))
    return max(1, math.ceil(n / int(cfg["whisper"]["chunk_s"] * spec.sample_rate)))


def vision_work(cfg: Dict, rows: List[int]) -> Dict[str, Dict[str, float]]:
    """The kernel bounds and model FLOPs of the vision forwards the run
    launched, each of its real rows."""
    ib, ibd = cfg["imagebind"], cfg["imagebind_dtype"]
    v = ib["vision"]
    vt = (ib["image_size"] // ib["patch_size"]) ** 2 + 1
    out = {"attn": 0.0, "mlp": 0.0, "flops": {ibd: sum(rows) * work.vision_flops(cfg)}}
    for b in rows:
        out["attn"] += v["depth"] * work.attn_call(b, v["heads"], vt, vt, v["width"] // v["heads"], ibd)["bound_s"]
        out["mlp"] += v["depth"] * work.mlp_call(b * vt, v["width"], int(v["width"] * v["mlp_ratio"]), ibd)["bound_s"]
    return out


def video_work(cfg: Dict, event, asr_rows, n_chunks: int) -> Dict[str, Dict[str, float]]:
    """The kernel bounds and model FLOPs of one ingested video's audio
    tower and Whisper."""
    ib = cfg["imagebind"]
    ibd, whd = cfg["imagebind_dtype"], cfg["whisper_dtype"]
    segs = len(event.features.get("audio", [])) if event.features.get("audio") is not None else 0
    clips = segs * ib["audio_clips"]
    a = ib["audio"]
    at = work.audio_tokens(cfg)
    w = cfg["whisper"]
    out = {"attn": 0.0, "mlp": 0.0, "flops": {ibd: 0.0, whd: 0.0}}

    def calls(n, chunk):
        return [min(chunk, n - lo) for lo in range(0, n, chunk)]

    for b in calls(segs, AUDIO_CHUNK):
        c = b * ib["audio_clips"]
        out["attn"] += a["depth"] * work.attn_call(c, a["heads"], at, at + 1, a["width"] // a["heads"], ibd)["bound_s"]
        out["mlp"] += a["depth"] * work.mlp_call(c * at, a["width"], int(a["width"] * a["mlp_ratio"]), ibd)["bound_s"]
    s, d = w["max_source_positions"], w["d_model"]
    for b in calls(n_chunks, ASR_BATCH):
        h = w["encoder_attention_heads"]
        out["attn"] += w["encoder_layers"] * work.attn_call(b, h, s, s, d // h, whd)["bound_s"]
        out["mlp"] += w["encoder_layers"] * work.mlp_call(b * s, d, w["encoder_ffn_dim"], whd)["bound_s"]
    out["flops"][ibd] += clips * work.audio_clip_flops(cfg)
    out["flops"][whd] += n_chunks * work.whisper_encoder_flops(cfg)
    if asr_rows[1] is not None:
        max_len = asr_rows[0].shape[1]
        for ln in asr_rows[1]:
            out["flops"][whd] += work.whisper_decode_flops(cfg, int(min(ln, max_len - 1)))
    return out


def run(ctx: Dict) -> Dict:
    """Set-up, window and check of one ingest cell; returns the run's record."""
    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    root = tempfile.mkdtemp(prefix="portbench-ingest-", dir=ctx.get("tmpdir"))
    try:
        return _run(ctx, cfg, traffic, seed, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, cfg, traffic, seed, device, root) -> Dict:
    import yaml
    from hippomm_tpu_torch.core.batch_process import process_video_folder
    from hippomm_tpu_torch.memory.store import MemoryStore

    check_port_config(cfg)
    params_ib = imagebind_params(cfg, seed, device)
    params_wh = whisper_params(cfg, seed, device)
    specs = media.specs_for(traffic, seed)
    sources = []
    for i, spec in enumerate(specs):
        stem = os.path.join(root, f"src{i}")
        media.write_video(stem + ".y4m", stem + ".wav", spec, device)
        sources.append({"y4m": stem + ".y4m", "wav": stem + ".wav", "spec": spec})
    mem = build_engine(cfg, params_ib, params_wh, device, os.path.join(root, "store_setup"))
    cap = AsrCapture(mem)
    towers = TowerCapture(mem.imagebind) if ctx["trace"] else None
    pcfg = port_config(cfg, "")
    kept_root = os.path.join(root, "stores")
    os.makedirs(kept_root)

    def one_call(k: int, srcs):
        folder = _link_folder(root, k, srcs)
        store = os.path.join(kept_root, f"store{k:04d}")
        mem.store = MemoryStore(store, features_format=pcfg.storage.features_format)
        stats = process_video_folder(folder, store, config=pcfg, memory_system=mem)
        tag = f"c{k:04d}v"
        evs = [e for e in mem.long_term_store[-2 * len(srcs):] if e.video_id.startswith(tag)]
        return stats, evs, store

    # warm-up: one video of the cell's own shapes (kernel build on a first run)
    with torch.no_grad():
        one_call(0, sources[:1])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ctx["mark_window_start"]()

    done, attempted, failed = [], 0, 0
    traced = Traced(enabled=bool(ctx["trace"]))
    t0 = time.perf_counter()
    tm0 = _timers(mem, towers)
    tm_after_trace = None
    k, t_end = 0, t0
    with torch.no_grad():
        while True:
            k += 1
            if ctx["trace"] and k == 1:
                rows_before = len(towers.rows)
                with traced:
                    stats, evs, store = one_call(k, sources)
                tm_after_trace = _timers(mem, towers)
                traced_rows = towers.rows[rows_before:]
                traced_call = k
            else:
                stats, evs, store = one_call(k, sources)
            t_end = time.perf_counter()
            print(f"call {k}: {stats['processed']} of {stats['total']} videos, ends at "
                  f"{t_end - t0:.3f} s", file=sys.stderr, flush=True)
            attempted += stats["total"]
            failed += stats["failed"] + (stats["total"] - stats["processed"] - stats["failed"])
            for ev in evs:
                src = int(ev.video_id.rsplit("v", 1)[-1])
                done.append({"call": k, "video_id": ev.video_id, "src": src, "event": ev, "store": store})
            if t_end - t0 >= ctx["seconds"]:
                break
    window_s = t_end - t0
    tm1 = _timers(mem, towers)
    media_s = sum(sources[d["src"]]["spec"].duration for d in done)
    out = {"attempted": attempted, "failed": failed, "window_s": window_s, "calls": k,
           "end_to_end": {"ingest_realtime_x": media_s / window_s if window_s > 0 else 0.0}}
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    def meta_of(d):
        with open(os.path.join(d["store"], "frames", d["video_id"], "metadata.yaml")) as f:
            return yaml.safe_load(f)

    if ctx["trace"]:
        base = tm_after_trace if k > traced_call else tm0
        span_media = sum(sources[d["src"]]["spec"].duration for d in done
                         if k == traced_call or d["call"] > traced_call)
        per_min = 60.0 / span_media if span_media else math.nan
        layer = {
            "extract_s": (_delta(base, tm1, EXTRACT) - _delta(base, tm1, ("extract_vision_feed",))) * per_min,
            "engine_s": _delta(base, tm1, ENGINE) * per_min,
            "encode_s": _delta(base, tm1, ENCODE) * per_min,
            "transcribe_s": _delta(base, tm1, ("transcribe",)) * per_min,
        }
        wk = {"attn": 0.0, "mlp": 0.0, "flops": {}}
        parts = [vision_work(cfg, traced_rows)]
        for d in done:
            if d["call"] == traced_call:
                n_chunks = asr_chunks(cfg, sources[d["src"]]["spec"])
                parts.append(video_work(cfg, d["event"], cap.rows(d["video_id"], n_chunks), n_chunks))
        for vw in parts:
            wk["attn"] += vw["attn"]
            wk["mlp"] += vw["mlp"]
            for dt, fl in vw["flops"].items():
                wk["flops"][dt] = wk["flops"].get(dt, 0.0) + fl
        out["layer"] = layer
        out["trace"] = traced
        out["work"] = {"attn_bound_s": wk["attn"], "attn_kernel_s": traced.kernel_s(ATTN_KERNELS),
                       "mlp_bound_s": wk["mlp"], "mlp_kernel_s": traced.kernel_s(MLP_KERNELS),
                       "flops": wk["flops"], "vision_rows": sum(traced_rows)}

    # ---- the check, once the window has closed and the peak is read ----
    ctx["window_closed"]()
    rng = np.random.default_rng(seed_words(seed, 29))
    sample = []
    for src in range(len(sources)):
        cands = [d for d in done if d["src"] == src]
        if cands:
            sample.append(cands[int(rng.integers(len(cands)))])
    outputs = []
    for d in sample:
        n_chunks = asr_chunks(cfg, sources[d["src"]]["spec"])
        toks, lens = cap.rows(d["video_id"], n_chunks)
        stms = MemoryStore(d["store"], features_format=pcfg.storage.features_format).load_checkpoint(
            d["video_id"]) or []
        outputs.append({"source": sources[d["src"]], "meta": meta_of(d), "event": d["event"],
                        "stms": stms, "tokens": toks, "lengths": lens})
    del mem, cap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.harness import check

    margin = 2.0 * float(ctx["limits"].get("vision_gap", 0.0))
    out["checks"] = check.ingest(cfg, outputs, params_ib, params_wh, device, bool(ctx.get("control")),
                                 dedup_margin=margin)
    out["sampled"] = [d["video_id"] for d in sample]
    return out
