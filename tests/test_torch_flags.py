"""The kill switches HIPPOMM_FLASH_ATTN and HIPPOMM_FUSED_MLP in the port,
against the JAX package's meaning of them.

`flash_default` / `fused_mlp_default` parse the flags as the JAX functions
do. At 0 the port's layers take none of K1, K4 (attention) or K2 (MLP) —
spies on the names the layers call see nothing — while K3 stays under
HIPPOMM_FUSED_BLOCK alone; and under every flag setting the port's
`encoder_block` agrees with the JAX `encoder_block` under the same flags
(fp32, 1e-5; the JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU). The kernels' launch counters
under the flags are held on the card in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models import layers as jl
from hippomm_tpu.ops import flash_attention as jfa
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.models import layers as tl
from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close

_FLAGS = ("HIPPOMM_FLASH_ATTN", "HIPPOMM_FLASH_BTHD", "HIPPOMM_FUSED_MLP", "HIPPOMM_FUSED_BLOCK")
_POLICIES = (jfa.flash_default, jfa.bthd_default, jfm.fused_mlp_default, jfm.fused_block_default,
             tfa.flash_default, tfa.bthd_default, tfm.fused_mlp_default, tfm.fused_block_default)


def _clear():
    for f in _POLICIES:
        f.cache_clear()
    jax.clear_caches()


@pytest.fixture
def flags(monkeypatch):
    """Sets the given flags (every other one unset) and re-reads the cached
    policies of both packages; clears them again afterwards."""

    def set_flags(**values):
        for name in _FLAGS:
            monkeypatch.delenv(name, raising=False)
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        _clear()

    yield set_flags
    for name in _FLAGS:
        monkeypatch.delenv(name, raising=False)
    _clear()


@pytest.fixture
def spies(monkeypatch):
    """Counts the port's kernel-wrapper calls by the names the layers call,
    and runs the JAX Pallas kernels in interpret mode (no Mosaic on the
    CPU)."""
    calls = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    real = {"K1": tfa.flash_mha, "K2": tfm.fused_mlp, "K3": tfm.fused_ln_mlp_residual,
            "K4": tfa.flash_mha_bthd}

    def spy(name):
        def run(*a):
            calls[name] += 1
            return real[name](*a)

        return run

    for mod, attr, name in ((tfa, "flash_mha", "K1"), (tl, "flash_mha", "K1"), (tfm, "fused_mlp", "K2"),
                            (tl, "fused_mlp", "K2"), (tfm, "fused_ln_mlp_residual", "K3"),
                            (tfa, "flash_mha_bthd", "K4")):
        monkeypatch.setattr(mod, attr, spy(name))
    jreal = {"flash": jfa.flash_mha, "bthd": jfa.flash_mha_bthd, "mlp": jfm.fused_mlp,
             "block": jfm.fused_ln_mlp_residual}
    monkeypatch.setattr(jfa, "flash_mha", lambda q, k, v, s, interpret=False, opt=False:
                        jreal["flash"](q, k, v, s, True, opt))
    monkeypatch.setattr(jfa, "flash_mha_bthd", lambda q, k, v, s, interpret=False:
                        jreal["bthd"](q, k, v, s, True))
    monkeypatch.setattr(jfm, "fused_mlp_vjp", lambda x, w1, b1, w2, b2, interpret=False:
                        jreal["mlp"](x, w1, b1, w2, b2, True))
    monkeypatch.setattr(jfm, "fused_ln_mlp_residual_vjp",
                        lambda x, g, b, w1, b1, w2, b2, eps=1e-6, interpret=False:
                        jreal["block"](x, g, b, w1, b1, w2, b2, eps, True))
    return calls


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _block(seed):
    """An encoder block at width 128 (the narrowest the K2/K3 gate admits),
    4 heads of 32 (the K4 gate admits H = 4), every parameter nonzero, and
    its input: numpy-seeded, carried to both packages."""
    p = jl.init_block(jax.random.PRNGKey(seed), 128)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), p)
    x = rng.standard_normal((2, 21, 128)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("value", ["0", "1", "off", "on", "false", "true"])
@pytest.mark.parametrize("flag,jax_policy,torch_policy", [
    ("HIPPOMM_FLASH_ATTN", jfa.flash_default, tfa.flash_default),
    ("HIPPOMM_FUSED_MLP", jfm.fused_mlp_default, tfm.fused_mlp_default),
])
def test_flag_parsing_matches_jax(flags, flag, jax_policy, torch_policy, value):
    flags(**{flag: value})
    assert torch_policy() is jax_policy() is (value in ("1", "on", "true"))


def test_flags_default_on(flags):
    """"auto" (or unset) is on in the port: on CUDA the kernels, on the CPU
    the wrappers' plain versions (the JAX package's "auto" is on for any
    accelerator backend)."""
    flags()
    assert tfa.flash_default() and tfm.fused_mlp_default()
    flags(HIPPOMM_FLASH_ATTN="auto", HIPPOMM_FUSED_MLP="AUTO")
    assert tfa.flash_default() and tfm.fused_mlp_default()


def test_flash_attn_off_takes_neither_k1_nor_k4(flags, spies):
    p, x = _block(3)
    tp, tx = _to_torch(p), torch.from_numpy(x)
    flags(HIPPOMM_FLASH_ATTN="0", HIPPOMM_FLASH_BTHD="1")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert spies["K1"] == spies["K4"] == 0 and spies["K2"] == 1
    # the same block with the flag on takes K4 (BTHD on), and K1 without it
    flags(HIPPOMM_FLASH_ATTN="1", HIPPOMM_FLASH_BTHD="1")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert (spies["K1"], spies["K4"]) == (0, 1)
    flags(HIPPOMM_FLASH_ATTN="1")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert (spies["K1"], spies["K4"]) == (1, 1)


def test_fused_mlp_off_takes_no_k2_and_keeps_k3(flags, spies):
    p, x = _block(4)
    tp, tx = _to_torch(p), torch.from_numpy(x)
    flags(HIPPOMM_FUSED_MLP="0")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert spies["K2"] == spies["K3"] == 0 and spies["K1"] == 1
    # K3 is gated by HIPPOMM_FUSED_BLOCK alone, as in the JAX package
    flags(HIPPOMM_FUSED_MLP="0", HIPPOMM_FUSED_BLOCK="1")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert (spies["K2"], spies["K3"]) == (0, 1)
    flags(HIPPOMM_FUSED_MLP="1")
    tl.encoder_block(tp, tx, 4, dtype=torch.float32)
    assert (spies["K2"], spies["K3"]) == (1, 1)


@pytest.mark.parametrize("setting", [
    {"HIPPOMM_FLASH_ATTN": "0"},
    {"HIPPOMM_FLASH_ATTN": "0", "HIPPOMM_FLASH_BTHD": "1"},
    {"HIPPOMM_FUSED_MLP": "0"},
    {"HIPPOMM_FUSED_MLP": "0", "HIPPOMM_FUSED_BLOCK": "1"},
    {"HIPPOMM_FLASH_ATTN": "0", "HIPPOMM_FUSED_MLP": "0"},
    {"HIPPOMM_FLASH_ATTN": "1", "HIPPOMM_FUSED_MLP": "1"},
    {"HIPPOMM_FLASH_ATTN": "1", "HIPPOMM_FLASH_BTHD": "1", "HIPPOMM_FUSED_MLP": "1"},
], ids=lambda s: ",".join(f"{k.split('_', 1)[1]}={v}" for k, v in s.items()))
def test_encoder_block_under_flags_matches_jax(request, flags, spies, setting):
    p, x = _block(5)
    flags(**setting)
    want = np.asarray(jl.encoder_block(p, jnp.asarray(x), 4, dtype=jnp.float32))
    got = tl.encoder_block(_to_torch(p), torch.from_numpy(x), 4, dtype=torch.float32).numpy()
    assert_close(request, got, want, 1e-5, scale=max(1.0, float(np.abs(want).max())))
    attn_on = setting.get("HIPPOMM_FLASH_ATTN", "auto") != "0"
    assert spies["K1"] + spies["K4"] == (1 if attn_on else 0)
    assert spies["K4"] == (1 if attn_on and setting.get("HIPPOMM_FLASH_BTHD") == "1" else 0)
    block = setting.get("HIPPOMM_FUSED_BLOCK") == "1"
    assert (spies["K2"], spies["K3"]) == ((0, 1) if block else
                                         (0 if setting.get("HIPPOMM_FUSED_MLP") == "0" else 1, 0))
