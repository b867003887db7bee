"""The VLM's part of the comparison that decides `correct` in the cells
that caption with Kimi-VL: the program's outputs against the plain float32
reference (`reference/kimi_vl.py`), and, when asked for, the reference in
fp8 (the control) against the same float32 reference. Lower is better:
  * vlm_vision_gap: the widest relative L2 distance of a sampled key
    frame's image-token row (MoonViT and the projector) from the
    reference's row for the same frame;
  * vlm_caption_logit_gap, vlm_summary_logit_gap: the widest, over the
    sampled caption rows (or the summaries), of a row's mean over its
    decoded positions of the gap by which the reference's logit of the
    program's token lies below the reference's best logit there; the
    reference is the teacher-forced full forward over the prompt and the
    program's tokens.
A row's mean and not its widest gap: with random weights a route flipped
near a tie moves the rest of its row, so the widest single gap of a bf16
run reaches the fp8 control's. The widest row, so that one row gone wrong
(another row's cache, a wrong slot) is not averaged away by the others.
`counts` reports, among the checked tokens, the share of (token, MoE
layer) routes whose chosen experts differ between the program's prefill of
the same tokens and the reference."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import kimi_vl as R
from portbench.reference.models import Prec


def _rel_rows(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.double(), ref.double()
    return float(((p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-12)).max())


class _Routes:
    """Records the chosen experts of every router call of a module's `route`."""

    def __init__(self, mod):
        self.mod, self.calls = mod, []

    def __enter__(self):
        self.orig = self.mod.route

        def rec(*a, **k):
            out = self.orig(*a, **k)
            self.calls.append(out[0].sort(dim=-1).values)
            return out

        self.mod.route = rec
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig
        return False


def pixels(cfg: Dict, rgb: np.ndarray, device) -> torch.Tensor:
    """(1, 3, H', W'): scaled with mean and std 0.5, zero-padded at the right
    and bottom to a multiple of patch × merge pixels."""
    vc = cfg["vision_config"]
    m = vc["patch_size"] * vc["merge_kernel_size"][0]
    x = torch.from_numpy(np.array(rgb)).to(device).permute(2, 0, 1)[None].float() / 127.5 - 1.0
    return torch.nn.functional.pad(x, (0, -x.shape[3] % m, 0, -x.shape[2] % m))


def _program_routes(vlm, seq: torch.Tensor, rows) -> List[torch.Tensor]:
    """The program's chosen experts at every position of its prefill of seq."""
    from hippomm_tpu_torch.models.kimi_vl import model as km

    t = vlm.cfg.text
    cache = torch.zeros((t.layers, 1, len(seq), t.kv_lora + t.rope_dim), dtype=vlm.dtype, device=seq.device)
    with _Routes(km) as routes:
        vlm.prefill(vlm.embed(seq.tolist(), [rows] if rows is not None else [])[None],
                    torch.tensor([len(seq)], device=seq.device), cache)
    return routes.calls


def _row(cfg: Dict, params: Dict, seq: torch.Tensor, start: int, rows, media_pad, mm=None):
    """(logits (positions, vocab) of seq[start:-1] under the reference, its
    routes there); mm None is float32."""
    kw = {} if mm is None else {"mm": mm}
    with _Routes(R) as routes:
        hid = R.lm_hidden(params, cfg, R.embed(params, cfg, seq, rows, media_pad), **kw)
    return R.logits(params, hid[start:-1], **kw), [r[start:-1] for r in routes.calls]


@torch.no_grad()
def vlm(cfg: Dict, samples: Dict, params: Dict, program, device, control: bool = False) -> Dict:
    """{"program": readings, "control": readings (when asked for), "counts"}.
    `samples`: "frames", each (RGB key frame, the program's image rows);
    "captions", each (prompt ids, the program's tokens, index of its frame);
    "summaries", each (prompt ids, the program's tokens). `program` is the
    run's model, whose prefill of the same tokens gives its routes."""
    R.no_tf32()
    fp8 = Prec("fp8").mm
    media_pad = cfg["tokenizer"]["special_ids"]["<|media_pad|>"]
    prog = {"vlm_vision_gap": 0.0, "vlm_caption_logit_gap": 0.0, "vlm_summary_logit_gap": 0.0}
    ctrl = {"vlm_vision_gap": 0.0, "vlm_caption_logit_gap": 0.0, "vlm_summary_logit_gap": 0.0}
    counts = {"vlm_frames": len(samples["frames"]), "vlm_caption_rows": len(samples["captions"]),
              "vlm_summaries": len(samples["summaries"]), "vlm_caption_positions": 0,
              "vlm_summary_positions": 0, "vlm_token_flip_pct": 0.0, "vlm_route_flip_pct": 0.0,
              "vlm_widest_caption_gap": 0.0}
    ref_rows, low_rows = [], []
    for rgb, rows in samples["frames"]:
        pix = pixels(cfg, rgb, device)
        ref = R.vision_forward(params, cfg, pix)[0]
        ref_rows.append(ref)
        prog["vlm_vision_gap"] = max(prog["vlm_vision_gap"], _rel_rows(rows.to(device), ref))
        if control:
            low_rows.append(R.vision_forward(params, cfg, pix, fp8)[0])
            ctrl["vlm_vision_gap"] = max(ctrl["vlm_vision_gap"], _rel_rows(low_rows[-1], ref))
    flips = routes = tok_flips = 0
    for kind, rows_of in (("caption", samples["captions"]), ("summary", samples["summaries"])):
        gaps, cgaps = [], []
        for item in rows_of:
            prompt, toks = item[0], item[1]
            if not len(toks):
                continue
            frame = item[2] if kind == "caption" else None
            seq = torch.tensor(list(prompt) + list(toks), dtype=torch.long, device=device)
            start = len(prompt) - 1
            logits, ref_routes = _row(cfg, params, seq, start, None if frame is None else ref_rows[frame], media_pad)
            best = logits.max(dim=-1).values
            gap = best - logits.gather(1, seq[start + 1:, None])[:, 0]
            gaps.append(float(gap.mean()))
            counts[f"vlm_{kind}_positions"] += int(gap.numel())
            tok_flips += int((gap > 0).sum())
            if frame is not None:
                counts["vlm_widest_caption_gap"] = max(counts["vlm_widest_caption_gap"], float(gap.max()))
            prog_routes = _program_routes(program, seq, None if frame is None else samples["frames"][frame][1].to(device))
            for a, b in zip(prog_routes, ref_routes):
                a = a[start:-1]
                flips += int((a != b).any(dim=-1).sum())
                routes += a.shape[0]
            if control:
                lo, _ = _row(cfg, params, seq, start, None if frame is None else low_rows[frame], media_pad, fp8)
                cgaps.append(float((best - logits.gather(1, lo.argmax(dim=-1)[:, None])[:, 0]).mean()))
            del logits
        if gaps:
            prog[f"vlm_{kind}_logit_gap"] = max(gaps)
            if control:
                ctrl[f"vlm_{kind}_logit_gap"] = max(cgaps)
    positions = counts["vlm_caption_positions"] + counts["vlm_summary_positions"]
    counts["vlm_token_flip_pct"] = 100.0 * tok_flips / max(1, positions)
    counts["vlm_route_flip_pct"] = 100.0 * flips / max(1, routes)
    out = {"program": prog, "counts": counts}
    if control:
        out["control"] = ctrl
    return out
