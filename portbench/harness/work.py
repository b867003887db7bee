"""Operations and bytes that the inputs need, and the card's peaks.

Torch-free arithmetic: every count is of the real rows a run produced
(key frames encoded, audio clips, real ASR chunks, decode steps of real
rows), never of the pad rows a bucket adds. A kernel's bound is the larger of its operations over the
peak of its precision and its bytes over the memory bandwidth; bytes count
each input read once and each output written once.

Peaks: NVIDIA H100 SXM data sheet, dense. fp32 work of the port's 3xTF32
tensor-core kernels is held against the TF32 peak: an fp32 product cannot
be done faster on this card, so a share of it stays at or below 100 %.
"""

from __future__ import annotations

import math
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """Least seconds the card could take for this work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# --------------------------------------------------------------- kernels


def attn_call(b: int, h: int, tq: int, tk: int, hd: int, dtype: str) -> Dict[str, float]:
    """K1/K4: softmax(q kᵀ) v over b·h heads, q/o of tq rows, k/v of tk."""
    e = ELEM_BYTES[dtype]
    flops = 4.0 * b * h * tq * tk * hd
    nbytes = e * b * h * hd * (2.0 * tq + 2.0 * tk)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes, dtype)}


def mlp_call(n: int, d: int, f: int, dtype: str) -> Dict[str, float]:
    """K2: fc2(gelu(fc1(x))) over n rows of width d, hidden f; weights and
    activations in `dtype`, biases fp32."""
    e = ELEM_BYTES[dtype]
    flops = 4.0 * n * d * f
    nbytes = e * (2.0 * n * d + 2.0 * d * f) + 4.0 * (d + f)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes, dtype)}


# ------------------------------------------------------------ whole towers


def encoder_flops(tokens: int, d: int, f: int, layers: int, kv_tokens: int = 0) -> float:
    """Pre-LN encoder blocks over one sequence: q/k/v/out projections, the
    two attention products (kv_tokens keys, default tokens), and the MLP."""
    kv = kv_tokens or tokens
    proj = 2.0 * tokens * d * 4 * d
    attn = 4.0 * tokens * kv * d
    mlp = 4.0 * tokens * d * f
    return layers * (proj + attn + mlp)


def vision_flops(cfg: Dict) -> float:
    """One image through ImageBind's vision tower (patchify, blocks, head)."""
    v = cfg["imagebind"]["vision"]
    p = cfg["imagebind"]["patch_size"]
    g = cfg["imagebind"]["image_size"] // p
    tokens = g * g + 1
    patchify = 2.0 * (tokens - 1) * v["width"] * 3 * p * p
    head = 2.0 * v["width"] * cfg["imagebind"]["embed_dim"]
    return patchify + encoder_flops(tokens, v["width"], v["width"] * v["mlp_ratio"], v["depth"]) + head


def audio_tokens(cfg: Dict) -> int:
    ib = cfg["imagebind"]
    h = (ib["audio_mel_bins"] - ib["audio_kernel"]) // ib["audio_stride"] + 1
    w = (ib["audio_target_len"] - ib["audio_kernel"]) // ib["audio_stride"] + 1
    return h * w + 1


def audio_clip_flops(cfg: Dict) -> float:
    """One 2 s clip through the audio tower (one bias_kv key per head)."""
    a = cfg["imagebind"]["audio"]
    ib = cfg["imagebind"]
    tokens = audio_tokens(cfg)
    patchify = 2.0 * (tokens - 1) * a["width"] * ib["audio_kernel"] ** 2
    head = 2.0 * a["width"] * ib["embed_dim"]
    return patchify + encoder_flops(tokens, a["width"], a["width"] * a["mlp_ratio"], a["depth"],
                                    kv_tokens=tokens + 1) + head


def whisper_encoder_flops(cfg: Dict) -> float:
    """One 30 s chunk: the two convolutions and the encoder blocks."""
    w = cfg["whisper"]
    s = w["max_source_positions"]
    d = w["d_model"]
    conv = 2.0 * (2 * s) * w["num_mel_bins"] * 3 * d + 2.0 * s * d * 3 * d
    return conv + encoder_flops(s, d, w["encoder_ffn_dim"], w["encoder_layers"])


def whisper_decode_flops(cfg: Dict, positions: int) -> float:
    """One chunk's decode: the cross-attention keys and values once, then
    every position the row ran through the decoder (prompt and generated
    tokens), each through all decoder layers and the tied vocabulary
    projection."""
    w = cfg["whisper"]
    d, s, f, L, V = (w["d_model"], w["max_source_positions"], w["decoder_ffn_dim"],
                     w["decoder_layers"], w["vocab_size"])
    cross_kv = L * 2 * 2.0 * s * d * d
    per_pos = L * (2.0 * d * 4 * d + 2.0 * d * 2 * d + 4.0 * s * d + 4.0 * d * f) + 2.0 * d * V
    self_attn = L * 2.0 * d * positions * (positions + 1)  # causal q·k and p·v
    return cross_kv + positions * per_pos + self_attn


def mfu_pct(flops_by_dtype: Dict[str, float], seconds: float) -> float:
    """Σ FLOPs_p / peak_p over the seconds of the window, in %."""
    if seconds <= 0:
        return math.nan
    return 100.0 * sum(fl / PEAK_FLOPS[dt] for dt, fl in flops_by_dtype.items()) / seconds
