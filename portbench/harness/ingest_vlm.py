"""The ingest cells with Kimi-VL-A3B-Instruct in process: folders of seeded
videos through the port's ingest CLI (`core/batch_process.process_video_folder`)
with one engine built in set-up, whose frame captions and event summaries
go to the seeded in-process VLM (`models/kimi_vl`, handed to the engine
through `models=`) in place of the stand-in clients, called on fresh
folders until the window's seconds have passed.

The record has the keys of `ingest.py`'s, and the check keeps every one of
its comparisons and adds the VLM's (`check_vlm`): the image tokens of
sampled key frames, and the reference's logits along the caption rows and
summaries the program decoded. The configuration sets the consolidation's
key-frame gate (`keyframe_dedup_threshold`, its `assumed` says why), and
the dedup is held to that gate. `engine_s` leaves out the `caption` and
`summary` stages, which `vlm_s` takes; the work adds the VLM's model FLOPs,
MoonViT's K1/K2 bounds and the decode steps' bound.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check, check_vlm, media, work, work_vlm
from portbench.harness.ingest import (ATTN_KERNELS, ENCODE, EXTRACT, MLP_KERNELS, AsrCapture,
                                      TowerCapture, _delta, _link_folder, _timers, asr_chunks,
                                      check_port_config, port_config, video_work, vision_work)
from portbench.harness.seeds import seed_words
from portbench.harness.trace import Traced
from portbench.harness.weights import imagebind_params, whisper_params
from portbench.harness.weights_vlm import kimi_vl_params

VLM = ("caption", "summary")
ENGINE = ("segmentation", "consolidate", "checkpoint")
FRAMES_PER_CALL = 8  # sampled key frames of each caption call, kept for the check


class VlmCapture:
    """Keeps, per video, a seeded sample of each caption call's key frames
    (the RGB frame and the program's image-token rows), those rows' prompt
    ids and decoded ids, and each summary's; and the ViT's chunk shapes.
    The engine's `replay` names the video. Nothing the program computes is
    changed."""

    def __init__(self, mem, vlm, seed: int):
        self.by_video: Dict[str, Dict] = {}
        self.vit_chunks: List = []
        rng = np.random.default_rng(seed_words(seed, 31))
        tl = threading.local()
        orig_replay, orig_enc, orig_gen, orig_vit = mem.replay, vlm.encode_images, vlm.generate_ids, vlm._vit

        def rec():
            vid = getattr(tl, "vid", None)
            if vid is None:
                return None
            return self.by_video.setdefault(vid, {"frames": [], "captions": [], "summaries": []})

        def replay(video_id=None):
            tl.vid = video_id
            try:
                return orig_replay(video_id)
            finally:
                tl.vid = None

        def encode(images):
            rows = orig_enc(images)
            r = rec()
            if r is not None and len(images):
                tl.pick = sorted(int(i) for i in rng.choice(len(images), min(FRAMES_PER_CALL, len(images)),
                                                            replace=False))
                tl.base = len(r["frames"])
                r["frames"] += [(images[i], rows[i].float().cpu()) for i in tl.pick]
            return rows

        def generate(prompts, images, max_tokens):
            out = orig_gen(prompts, images, max_tokens)
            r = rec()
            if r is not None:
                if any(len(i) for i in images):
                    r["captions"] += [(prompts[i], out[i], tl.base + j) for j, i in enumerate(tl.pick)]
                else:
                    r["summaries"] += [(p, o) for p, o in zip(prompts, out)]
            return out

        def vit(pixels):
            self.vit_chunks.append(tuple(pixels.shape))
            return orig_vit(pixels)

        mem.replay, vlm.encode_images, vlm.generate_ids, vlm._vit = replay, encode, generate, vit


def check_vlm_config(cfg: Dict) -> None:
    """The port's Kimi-VL variant has the configuration file's sizes."""
    from hippomm_tpu_torch.models.kimi_vl.model import hf_config
    from hippomm_tpu_torch.models.kimi_vl.config import get_config

    pc = get_config(cfg["vlm_variant"])
    got = hf_config(pc)
    bad = {k: (v, cfg.get(k)) for k, v in got.items() if k != "vision_config" and cfg.get(k) != v}
    bad.update({f"vision_config.{k}": (v, cfg["vision_config"].get(k)) for k, v in got["vision_config"].items()
                if cfg["vision_config"].get(k) != v})
    if pc.n_special != cfg["tokenizer"]["n_special"] or pc.cache_slots != cfg["vlm_generation"]["cache_slots"]:
        bad["generation"] = (pc.n_special, pc.cache_slots)
    if bad:
        raise ValueError(f"the port's Kimi-VL variant differs from the configuration file: {bad}")


def vlm_port_config(cfg: Dict, store: str):
    """The port's Config for the cell: `ingest.port_config`'s, with the
    VLM variant and the configuration's key-frame gate."""
    c = port_config(cfg, store)
    c.models.vlm_variant = cfg["vlm_variant"]
    c.processing.keyframe_dedup_threshold = float(cfg["keyframe_dedup_threshold"])
    return c


@contextlib.contextmanager
def dedup_gate(thr: float):
    """`check.ingest` holds the key-frame dedup to the engine's default gate;
    within this, to `thr`, the gate the cell's engine ran at."""
    orig = check.dedup_faults
    check.dedup_faults = lambda ref, kept, _default, margin: orig(ref, kept, thr, margin)
    try:
        yield
    finally:
        check.dedup_faults = orig


def vit_work(cfg: Dict, chunks) -> Dict:
    """MoonViT's K1/K2 bounds (each launch the chunk made) and its FLOPs."""
    vc = cfg["vision_config"]
    dt = cfg["vlm_dtype"]
    out = {"attn": 0.0, "mlp": 0.0, "flops": 0.0}
    w, heads, depth = vc["hidden_size"], vc["num_attention_heads"], vc["num_hidden_layers"]
    for b, _, hh, ww in chunks:
        n = (hh // vc["patch_size"]) * (ww // vc["patch_size"])
        out["attn"] += depth * work.attn_call(b, heads, n, n, w // heads, dt)["bound_s"]
        out["mlp"] += depth * work.mlp_call(b * n, w, vc["intermediate_size"], dt)["bound_s"]
        out["flops"] += b * work_vlm.vit_flops(cfg, n)
    return out


def build_engine(cfg: Dict, params_ib, params_wh, vlm, device, store: str):
    """The engine as the deployment builds it, with the benchmark's weights
    and the seeded VLM as its captioner and summariser."""
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.models.foundation import ImageBind, Whisper

    ib = ImageBind(variant=cfg["imagebind_variant"], dtype=getattr(torch, cfg["imagebind_dtype"]),
                   device=device, params=params_ib)
    wh = Whisper(model_name=cfg["whisper_variant"], variant=cfg["whisper_variant"],
                 dtype=getattr(torch, cfg["whisper_dtype"]), beam_size=cfg["whisper_beam_size"], device=device,
                 params=params_wh)
    return HippocampalMemory(vlm_port_config(cfg, store), models={"imagebind": ib, "whisper": wh, "vlm": vlm},
                             device=device)


def run(ctx: Dict) -> Dict:
    """Set-up, window and check of one cell; returns the run's record."""
    root = tempfile.mkdtemp(prefix="portbench-ingest-vlm-", dir=ctx.get("tmpdir"))
    try:
        return _run(ctx, ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # the captures' wrappers and the models they wrap hold each other:
        # collect them here, so the next run in this process finds the card free
        gc.collect()


def _run(ctx, cfg, traffic, seed, device, root) -> Dict:
    import yaml
    from hippomm_tpu_torch.core.batch_process import process_video_folder
    from hippomm_tpu_torch.memory.store import MemoryStore
    from hippomm_tpu_torch.models.kimi_vl.model import KimiVL

    check_port_config(cfg)
    check_vlm_config(cfg)
    params_ib = imagebind_params(cfg, seed, device)
    params_wh = whisper_params(cfg, seed, device)
    params_vlm = kimi_vl_params(cfg, seed, device)
    vlm = KimiVL(cfg["vlm_variant"], params=params_vlm, dtype=getattr(torch, cfg["vlm_dtype"]), device=device)
    specs = media.specs_for(traffic, seed)
    sources = []
    for i, spec in enumerate(specs):
        stem = os.path.join(root, f"src{i}")
        media.write_video(stem + ".y4m", stem + ".wav", spec, device)
        sources.append({"y4m": stem + ".y4m", "wav": stem + ".wav", "spec": spec})
    mem = build_engine(cfg, params_ib, params_wh, vlm, device, os.path.join(root, "store_setup"))
    cap = AsrCapture(mem)
    vcap = VlmCapture(mem, vlm, seed)
    towers = TowerCapture(mem.imagebind) if ctx["trace"] else None
    pcfg = vlm_port_config(cfg, "")
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

    # warm-up: one video of the cell's own shapes (kernel builds and the
    # decode graphs of the caption and summary buckets on a first run)
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
                rows_before, loops_before, vit_before = len(towers.rows), len(vlm.loops), len(vcap.vit_chunks)
                with traced:
                    stats, evs, store = one_call(k, sources)
                tm_after_trace = _timers(mem, towers)
                traced_rows = towers.rows[rows_before:]
                traced_loops = list(vlm.loops)[loops_before:]
                traced_vit = vcap.vit_chunks[vit_before:]
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
    out["vlm"] = {"experts": cfg["n_routed_experts"], "graph_bytes": vlm.graph_bytes()}

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
            "vlm_s": _delta(base, tm1, VLM) * per_min,
        }
        wk = {"attn": 0.0, "mlp": 0.0, "flops": {}}
        parts = [vision_work(cfg, traced_rows)]
        for d in done:
            if d["call"] == traced_call:
                n_chunks = asr_chunks(cfg, sources[d["src"]]["spec"])
                parts.append(video_work(cfg, d["event"], cap.rows(d["video_id"], n_chunks), n_chunks))
        vw = vit_work(cfg, traced_vit)
        lw = work_vlm.loops_work(cfg, traced_loops)
        parts.append({"attn": vw["attn"], "mlp": vw["mlp"],
                      "flops": {"bfloat16": vw["flops"] + lw["flops"]["bfloat16"], "float32": lw["flops"]["float32"]}})
        for p in parts:
            wk["attn"] += p["attn"]
            wk["mlp"] += p["mlp"]
            for dt, fl in p["flops"].items():
                wk["flops"][dt] = wk["flops"].get(dt, 0.0) + fl
        out["layer"] = layer
        out["trace"] = traced
        out["work"] = {"attn_bound_s": wk["attn"], "attn_kernel_s": traced.kernel_s(ATTN_KERNELS),
                       "mlp_bound_s": wk["mlp"], "mlp_kernel_s": traced.kernel_s(MLP_KERNELS),
                       "flops": wk["flops"], "vision_rows": sum(traced_rows),
                       "vlm_decode_bound_s": lw["decode_bound_s"]}

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
    # the VLM's samples of the sampled videos; the decode's cache and graphs go first
    samples = {"frames": [], "captions": [], "summaries": []}
    missing = 0  # sampled videos whose captions or summary the VLM did not write
    for d in sample:
        r = vcap.by_video.get(d["video_id"], {"frames": [], "captions": [], "summaries": []})
        base = len(samples["frames"])
        samples["frames"] += r["frames"]
        samples["captions"] += [(p, t, base + i) for p, t, i in r["captions"]]
        samples["summaries"] += r["summaries"]
        missing += int(not r["captions"] or not r["summaries"])
    vlm._graphs.clear()
    vlm._pool = None
    del mem, cap, vcap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    control = bool(ctx.get("control"))
    vc = check_vlm.vlm(cfg, samples, params_vlm, vlm, device, control)
    vc["program"]["vlm_missing"] = missing
    del vlm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    margin = 2.0 * float(ctx["limits"].get("vision_gap", 0.0))
    with dedup_gate(float(cfg["keyframe_dedup_threshold"])):
        ic = check.ingest(cfg, outputs, params_ib, params_wh, device, control, dedup_margin=margin)
    out["checks"] = {"program": {**ic["program"], **vc["program"]}, "counts": {**ic["counts"], **vc["counts"]}}
    if control:
        out["checks"]["control"] = {**ic["control"], **vc["control"]}
    out["sampled"] = [d["video_id"] for d in sample]
    return out
