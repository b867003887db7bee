"""Shared check of the PyTorch port's parity tests.

`assert_close` asserts the maximum absolute difference and adds it to the
test's report as a user property, so the JUnit XML of a run holds every
measured error beside its tolerance:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels.py \
        tests/test_torch_imagebind.py tests/test_torch_ingest.py --junitxml=parity.xml
"""

import numpy as np


def assert_close(request, got, want, tol: float, what: str = "max_abs_err", scale: float = 1.0) -> float:
    """max |got - want| / scale <= tol; records `what` = "<err> <= <tol>"."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) / scale
    request.node.user_properties.append((what, f"{err!r} <= {tol!r}"))
    assert err <= tol, f"{what}: {err!r} > {tol!r}"
    return err


def imagebind_params_np(cfg, seed: int = 0) -> dict:
    """Random ImageBind parameters in the JAX package's tree layout (blocks
    stacked along a leading depth axis), as numpy arrays made from `seed` —
    the tree `init_imagebind` returns, without its compile. Biases and norm
    parameters are nonzero, so every term of a forward counts."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.02):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    def blocks(tower, bias_kv=False):
        d, depth = tower.width, tower.depth
        h = int(d * tower.mlp_ratio)
        b = {
            "attn": {"in_proj": {"weight": r(depth, 3 * d, d, s=d ** -0.5), "bias": r(depth, 3 * d)},
                     "out_proj": {"weight": r(depth, d, d, s=d ** -0.5), "bias": r(depth, d)}},
            "mlp": {"fc1": {"weight": r(depth, h, d, s=d ** -0.5), "bias": r(depth, h)},
                    "fc2": {"weight": r(depth, d, h, s=h ** -0.5), "bias": r(depth, d)}},
            "norm_1": {"weight": 1.0 + r(depth, d), "bias": r(depth, d)},
            "norm_2": {"weight": 1.0 + r(depth, d), "bias": r(depth, d)},
        }
        if bias_kv:
            b["attn"]["bias_k"] = r(depth, 1, 1, d)
            b["attn"]["bias_v"] = r(depth, 1, 1, d)
        return b

    def ln(d):
        return {"weight": 1.0 + r(d), "bias": r(d)}

    vw, aw, tw = cfg.vision.width, cfg.audio.width, cfg.text.width
    return {
        "vision": {"patch_conv": {"weight": r(vw, 3, 2, cfg.patch_size, cfg.patch_size)},
                   "cls_token": r(1, 1, vw), "pos_embed": r(1, cfg.vision_tokens, vw),
                   "pre_ln": ln(vw), "blocks": blocks(cfg.vision), "head_ln": ln(vw),
                   "head_proj": {"weight": r(cfg.embed_dim, vw)}},
        "audio": {"patch_conv": {"weight": r(aw, 1, cfg.audio_kernel, cfg.audio_kernel)},
                  "patch_norm": ln(aw), "cls_token": r(1, 1, aw), "pos_embed": r(1, cfg.audio_tokens, aw),
                  "blocks": blocks(cfg.audio, bias_kv=True), "head_ln": ln(aw),
                  "head_proj": {"weight": r(cfg.embed_dim, aw)}},
        "text": {"token_embedding": r(cfg.vocab_size, tw), "pos_embed": r(1, cfg.context_length, tw),
                 "blocks": blocks(cfg.text), "final_ln": ln(tw),
                 "head_proj": {"weight": r(cfg.embed_dim, tw)},
                 "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)},
    }
