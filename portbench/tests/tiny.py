"""Tiny sizes of the cells for CPU tests: the port's `tiny` variants of
ImageBind and Whisper and short 640×360 videos."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def tiny_config(base: str = "ib_huge-distil_large_v3") -> dict:
    cfg = copy.deepcopy(load("configs", base))
    cfg["imagebind_variant"] = "tiny"
    cfg["whisper_variant"] = "tiny"
    cfg["imagebind_dtype"] = "float32"
    cfg["whisper_dtype"] = "float32"
    ib = cfg["imagebind"]
    ib["vision"].update(width=64, depth=2, heads=4)
    ib["audio"].update(width=48, depth=2, heads=4)
    ib["text"].update(width=64, depth=2, heads=4)
    ib.update(image_size=56, vocab_size=512, context_length=16)
    cfg["whisper"].update(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                          decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
                          vocab_size=256, num_mel_bins=80, max_source_positions=100,
                          max_target_positions=32, decoder_start_token_id=250, eos_token_id=251,
                          lang_en_token_id=252, transcribe_token_id=253, no_timestamps_token_id=254)
    return cfg


def tiny_ingest_traffic() -> dict:
    t = load("traffic", "vlog")
    t.update(duration_s=40, fps=2, cut_every_s=12, silence_first_s=20, silence_every_s=60)
    return t


def ctx(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool = False,
        limits=None, control=False, tmpdir=None) -> dict:
    import torch

    return {"config": cfg, "traffic": traffic, "seed": seed, "seconds": seconds, "trace": trace,
            "device": torch.device("cpu"), "limits": limits or {}, "control": control,
            "tmpdir": tmpdir, "mark_window_start": lambda: None, "window_closed": lambda: None}
