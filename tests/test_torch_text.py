"""Parity of the port's text path against the JAX package, on the CPU:
both tokenizers, the ImageBind text tower (`text_forward`) in fp32 with
weights carried across, and the `ImageBind.encode_text*` wrapper. At width
128 the tower's MLP passes the K2/K3 gate; with HIPPOMM_FUSED_BLOCK on the
JAX half-block kernel runs in interpret mode through a spy, as
test_torch_fused_block.py runs it."""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.imagebind import model as jm
from hippomm_tpu.models.imagebind import preprocess as jpre
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.imagebind import model as tm
from hippomm_tpu_torch.models.imagebind import preprocess as tpre
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close, imagebind_params_np

_TEXTS = ["a red square moves left", "Café  naïve 42!", "", "hi hey hi", "x " * 40]


def _write_merges(path, merges):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n")
        f.write("\n".join(" ".join(m) for m in merges))


def test_tokenizers_match_jax(tmp_path, monkeypatch):
    p = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    _write_merges(p, [("h", "i</w>"), ("h", "e"), ("he", "y</w>"), ("r", "e"), ("re", "d</w>")])
    for jt, tt in (
        (jpre.ClipTokenizer(p, context_length=16), tpre.ClipTokenizer(p, context_length=16)),
        (jpre.HashTokenizer(512, 16), tpre.HashTokenizer(512, 16)),
        (jpre.HashTokenizer(), tpre.HashTokenizer()),
    ):
        np.testing.assert_array_equal(tt(_TEXTS), jt(_TEXTS))
        assert (tt.sot, tt.eot) == (jt.sot, jt.eot)
    # the same search order: a merges file in the model dir, then the
    # variable, else the hashing tokenizer
    assert isinstance(tpre.load_tokenizer(str(tmp_path)), tpre.ClipTokenizer)
    monkeypatch.setenv("HIPPOMM_BPE_PATH", p)
    assert isinstance(tpre.load_tokenizer(None), tpre.ClipTokenizer)
    monkeypatch.delenv("HIPPOMM_BPE_PATH")
    assert isinstance(tpre.load_tokenizer(None), tpre.HashTokenizer)
    assert isinstance(jpre.load_tokenizer(None), jpre.HashTokenizer)


def _text_params(cfg_j, cfg_t, seed):
    params_np = {"text": imagebind_params_np(cfg_j, seed)["text"]}
    return jax.tree.map(jnp.asarray, params_np), params_from_jax(params_np, cfg_t, "cpu", torch.float32)


def _width_128(mod):
    c = mod.tiny_config()
    return dataclasses.replace(c, text=dataclasses.replace(c.text, width=128))


def _tokens(cfg, n=3):
    return jpre.HashTokenizer(cfg.vocab_size, cfg.context_length)(_TEXTS[:n])


def test_text_forward_matches_jax(request):
    cfg_j, cfg_t = jm.tiny_config(), tm.tiny_config()
    params_j, params_t = _text_params(cfg_j, cfg_t, 0)
    tok = _tokens(cfg_j)
    want = np.asarray(jm.text_forward(params_j, jnp.asarray(tok), cfg_j, jnp.float32))
    got = tm.text_forward(params_t, torch.from_numpy(tok), cfg_t, torch.float32).numpy()
    assert got.shape == (3, 1024)
    scale = float(np.exp(np.asarray(params_j["text"]["logit_scale"])))
    assert_close(request, got, want, 1e-5, scale=scale)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), scale, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_text_forward_width_128_matches_jax(request, monkeypatch, fused):
    """The K2 route (plain version on the CPU) or, with the fused-block flag,
    the K3 route, against the JAX tower — its kernel in interpret mode."""
    cfg_j, cfg_t = _width_128(jm), _width_128(tm)
    params_j, params_t = _text_params(cfg_j, cfg_t, 2)
    calls = {"jax": [], "torch": []}
    if fused:
        real_j, real_t = jfm.fused_ln_mlp_residual, tfm.fused_ln_mlp_residual

        def jax_spy(x, g, b, w1, b1, w2, b2, eps=1e-6, interpret=False):
            calls["jax"].append(tuple(x.shape))
            return real_j(x, g, b, w1, b1, w2, b2, eps, True)

        monkeypatch.setattr(jfm, "fused_ln_mlp_residual_vjp", jax_spy)
        monkeypatch.setattr(jfm, "fused_block_default", lambda: True)
        monkeypatch.setattr(tfm, "fused_block_default", lambda: True)
        monkeypatch.setattr(tfm, "fused_ln_mlp_residual",
                            lambda x, *a: calls["torch"].append(tuple(x.shape)) or real_t(x, *a))
        jax.clear_caches()
    else:
        real_k2 = tfm.fused_mlp
        monkeypatch.setattr(tfm, "fused_mlp", lambda x, *a: calls["torch"].append(tuple(x.shape)) or real_k2(x, *a))
        import hippomm_tpu_torch.models.layers as tl

        monkeypatch.setattr(tl, "fused_mlp", tfm.fused_mlp)
    tok = _tokens(cfg_j, 2)
    try:
        want = np.asarray(jm.text_forward(params_j, jnp.asarray(tok), cfg_j, jnp.float32))
    finally:
        if fused:
            jax.clear_caches()
    got = tm.text_forward(params_t, torch.from_numpy(tok), cfg_t, torch.float32).numpy()
    rows = 2 * cfg_t.context_length
    assert calls["torch"] == [(rows, 128)] * cfg_t.text.depth
    if fused:
        assert calls["jax"] == [(rows, 128)]  # traced once, inside the scan
    scale = float(np.exp(np.asarray(params_j["text"]["logit_scale"])))
    assert_close(request, got, want, 1e-5, scale=scale)


def test_encode_text_matches_jax(request, monkeypatch):
    monkeypatch.setattr(jm, "init_imagebind", lambda key, cfg: imagebind_params_np(cfg, 4))
    jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
    tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu",
                                            torch.float32))
    texts = ["a red square", "what sound plays"]
    want = jib.encode_text(texts)
    dev = tib.encode_text_device(texts)
    assert isinstance(dev, torch.Tensor) and dev.shape == (2, 1024)
    got = tib.encode_text(texts)
    assert got.dtype == np.float32
    scale = float(np.exp(np.asarray(jib.params["text"]["logit_scale"])))
    assert_close(request, got, want, 1e-5, scale=scale)
    assert tib.encode_text([]).shape == (0, 1024)
    assert_close(request, tib.extract_features({"text": texts})["text"], want, 1e-5,
                 "max_abs_err_extract", scale=scale)
