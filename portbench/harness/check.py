"""The comparison that decides `correct`: the program's outputs against the
plain reference in float32, and, when asked for, the reference computed in
a lower precision (the control) against the same float32 reference.

Every number is a distance from the reference, lower is better:
  * *_faults: decisions of the key-frame walk, the segmentation or the
    key-frame dedup that the reference makes the other way (beyond the
    rounding of a score that sits on its threshold)
  * vision_gap, audio_gap: the widest relative L2 distance of a persisted
    embedding row from the reference's row for the same frame or segment
  * asr_logit_gap: the widest gap by which a decoded token's reference
    logit lies below the reference's best at its position
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import media as rm
from portbench.reference import models as M

BLOCK_ROWS = 32
PROMPT_LEN = 3  # <|startoftranscript|> <|en|> <|transcribe|>
# the control: each model's stated precision's next lower one
LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def _rel_gap(prog: np.ndarray, ref: torch.Tensor) -> float:
    r = ref.double().cpu().numpy()
    p = np.asarray(prog, np.float64)
    return float((np.linalg.norm(p - r, axis=1) / np.maximum(np.linalg.norm(r, axis=1), 1e-12)).max()) \
        if len(p) else 0.0


def _worst(d: Dict, key: str, v: float) -> None:
    d[key] = max(d.get(key, 0.0), v)


def dedup_faults(ref_rows: torch.Tensor, kept, thr: float, margin: float) -> int:
    """Decisions of the greedy key-frame dedup (keep a row iff its cosine to
    every row kept before it is under thr) that the reference embeddings
    make the other way by more than `margin`; the walk follows the
    program's decisions."""
    u = ref_rows.double()
    u = u / u.norm(dim=1, keepdim=True).clamp(min=1e-12)
    kept = set(int(i) for i in kept)
    faults = 0 if 0 in kept else 1
    for i in range(1, len(u)):
        prev = [j for j in kept if j < i]
        s = float((u[prev] @ u[i]).max()) if prev else -1.0
        if i in kept and s > thr + margin:
            faults += 1
        if i not in kept and s < thr - margin:
            faults += 1
    return faults


@torch.no_grad()
def ingest(cfg: Dict, outputs: List[Dict], params_ib: Dict, params_wh: Dict, device,
           control: bool = False, dedup_margin: float = 0.0) -> Dict:
    """{"program": {name: reading}, "control": {name: reading}, "counts": ...};
    the control's readings only when asked for.
    Each output holds the video's source files, its metadata.yaml, its
    checkpointed short-term memories (one per segment, every key frame's
    row), its event (the deduplicated rows) and its decoded token rows."""
    M.no_tf32()
    controls = ("control",) if control else ()
    ib_low = M.Prec(LOWER[cfg["imagebind_dtype"]])
    wh_low = M.Prec(LOWER[cfg["whisper_dtype"]])
    prog = {"keyframe_faults": 0, "cut_faults": 0, "dedup_faults": 0, "vision_gap": 0.0,
            "audio_gap": 0.0, "asr_logit_gap": 0.0}
    ctrl = {c: {} for c in controls}
    counts = {"videos": len(outputs), "candidates": 0, "keyframes": 0, "segments": 0, "event_rows": 0,
              "asr_rows": 0, "asr_positions": 0, "asr_eot_rows": 0, "asr_distinct_tokens": 0}
    ib, w = cfg["imagebind"], cfg["whisper"]
    sr = 16000
    for o in outputs:
        src, meta, ev, stms = o["source"], o["meta"], o["event"], o["stms"]
        y = rm.Y4M(src["y4m"])
        idx, times = rm.candidates(y.num_frames, y.fps)
        lumas = [rm.box_luma(y.luma(i), 90, 160) for i in idx]
        at = {round(t * 1e6): j for j, t in enumerate(times)}
        kept = [at.get(round(float(t) * 1e6)) for t in meta["frame_times"]]
        prog["keyframe_faults"] += sum(j is None for j in kept)
        kept = sorted(j for j in kept if j is not None)
        prog["keyframe_faults"] += rm.keyframe_faults(lumas, times, kept)
        counts["candidates"] += len(idx)
        counts["keyframes"] += len(kept)

        # segmentation: the checkpointed memories are the segments, in order
        pcm = rm.read_wav(src["wav"])
        stms = sorted(stms, key=lambda m: m.segment_info["start_time"])
        bounds = [(float(m.segment_info["start_time"]), float(m.segment_info["end_time"])) for m in stms]
        cuts = [b[0] for b in bounds[1:]]
        counts["segments"] += len(bounds)
        fs = [rm.ssim(lumas[a], lumas[b]) for a, b in zip(kept[:-1], kept[1:])]
        db = rm.window_db(pcm, sr // 2, sr // 10)
        prog["cut_faults"] += rm.cut_faults(cuts, [times[j] for j in kept], fs, db, y.duration)
        if not bounds or bounds[0][0] != 0.0 or abs(bounds[-1][1] - y.duration) > 1e-6:
            prog["cut_faults"] += 1

        # vision: every key frame's row against the reference's encode of its frame
        v_rows, v_times = [], []
        for m in stms:
            f = m.features.get("vision")
            if f is not None and len(f):
                v_rows.append(np.asarray(f))
                v_times += [float(t) for t in m.segment_info.get("frame_times", [])][: len(f)]
        v_rows = np.concatenate(v_rows) if v_rows else np.zeros((0, ib["embed_dim"]))
        if len(v_times) != len(kept) or len(v_rows) != len(v_times):
            prog["keyframe_faults"] += 1
        if v_times:
            imgs = torch.stack([rm.image_tensor(y.rgb(int(round(t * y.fps))), ib["image_size"])
                                for t in v_times]).to(device)
            ref = M.in_blocks(lambda x: M.vision_forward(params_ib, cfg, x), imgs, BLOCK_ROWS)
            _worst(prog, "vision_gap", _rel_gap(v_rows, ref))
            # the event keeps the rows the dedup chose, unchanged
            ev_rows = np.asarray(ev.features.get("vision", np.zeros((0, ib["embed_dim"]))))
            pos = {round(t * 1e6): i for i, t in enumerate(v_times)}
            chosen = [pos.get(round(float(t) * 1e6)) for t in ev.feature_times.get("vision", [])]
            counts["event_rows"] += len(chosen)
            if None in chosen or any(not np.array_equal(ev_rows[k], v_rows[i]) for k, i in enumerate(chosen)):
                prog["dedup_faults"] += 1
            else:
                prog["dedup_faults"] += dedup_faults(ref, chosen, 0.9, dedup_margin)
            for c in controls:
                out = M.in_blocks(lambda x: M.vision_forward(params_ib, cfg, x, ib_low), imgs, BLOCK_ROWS)
                _worst(ctrl[c], "vision_gap", _rel_gap(out.double().cpu().numpy(), ref))

        # audio: one row per segment of at least 100 ms
        segs, rows = [], []
        for (s, e), m in zip(bounds, stms):
            a = pcm[int(s * sr):int(e * sr)]
            f = m.features.get("audio")
            if (len(a) >= sr // 10) != (f is not None and len(f) > 0):
                prog["cut_faults"] += 1
            elif f is not None and len(f):
                segs.append(a)
                rows.append(np.asarray(f)[0])
        if segs:
            fb = torch.stack([rm.audio_tensor(s, cfg, device) for s in segs])
            ref = M.in_blocks(lambda x: M.audio_forward(params_ib, cfg, x), fb, BLOCK_ROWS)
            _worst(prog, "audio_gap", _rel_gap(np.stack(rows), ref))
            for c in controls:
                out = M.in_blocks(lambda x: M.audio_forward(params_ib, cfg, x, ib_low), fb, BLOCK_ROWS)
                _worst(ctrl[c], "audio_gap", _rel_gap(out.double().cpu().numpy(), ref))

        # ASR: the reference's logits along the tokens the engine decoded
        toks, lens = o["tokens"], o["lengths"]
        chunks = rm.asr_chunks(pcm, w["chunk_s"])
        if toks is None or len(toks) != len(chunks):
            prog["asr_logit_gap"] = float("inf")
            continue
        mel = rm.whisper_mel(torch.from_numpy(chunks).to(device), w["num_mel_bins"])
        mel = mel[:, :, : 2 * w["max_source_positions"]]
        pairs = [("program", M.FP32)] + [(c, wh_low) for c in controls]
        encs = {name: M.in_blocks(lambda x: M.whisper_encode(params_wh, cfg, x, pr), mel, 2)
                for name, pr in pairs}
        max_len = toks.shape[1]
        counts["asr_distinct_tokens"] = max(counts["asr_distinct_tokens"], len(np.unique(toks[:, PROMPT_LEN:])))
        for j in range(len(toks)):
            last = int(min(lens[j], max_len - 1))
            counts["asr_rows"] += 1
            counts["asr_eot_rows"] += int(lens[j] < max_len)
            counts["asr_positions"] += max(0, last + 1 - PROMPT_LEN)
            if last < PROMPT_LEN:
                continue
            seq = torch.from_numpy(toks[j, :last].astype(np.int64)).to(device)[None]
            tgt = torch.from_numpy(toks[j, PROMPT_LEN:last + 1].astype(np.int64)).to(device)
            ref = M.whisper_logits(params_wh, cfg, seq, encs["program"][j:j + 1])[0, PROMPT_LEN - 1:]
            best = ref.max(dim=-1).values
            gap = (best - ref.gather(1, tgt[:, None])[:, 0]).max().item()
            _worst(prog, "asr_logit_gap", gap)
            for c, pr in pairs[1:]:
                lo = M.whisper_logits(params_wh, cfg, seq, encs[c][j:j + 1], pr)[0, PROMPT_LEN - 1:]
                pick = lo.argmax(dim=-1)
                _worst(ctrl[c], "asr_logit_gap", (best - ref.gather(1, pick[:, None])[:, 0]).max().item())
    return {"program": prog, **ctrl, "counts": counts}

