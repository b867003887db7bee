"""The port's training checkpoints (train/checkpoint): an exact round trip,
`like` mismatches refused, and training resumed from a loaded file taking
the same step as training without the save."""

import numpy as np
import pytest
import torch

from hippomm_tpu_torch.models.imagebind.model import tiny_config
from hippomm_tpu_torch.train import checkpoint as ck
from hippomm_tpu_torch.train import contrastive as tc


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(4, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(4, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    return images, tokens


def test_flatten_round_trip_keeps_lists_and_order():
    params = tc.init_train_state(tiny_config(), device="cpu")[0]
    flat = ck.flatten_params(params)
    assert "vision.blocks.1.attn.in_proj.weight" in flat and "text.logit_scale" in flat
    back = ck.unflatten_params(flat)
    assert isinstance(back["vision"]["blocks"], list) and len(back["vision"]["blocks"]) == 2
    assert list(ck.flatten_params(back)) == list(flat)


@pytest.mark.parametrize("with_like", [False, True])
def test_save_load_round_trip_is_exact(tmp_path, with_like):
    cfg = tiny_config()
    params, opt = tc.init_train_state(cfg, device="cpu", learning_rate=1e-3, seed=3)
    tc.make_train_step(cfg, opt, dtype=torch.float32)(params, *_batch(cfg, 0))  # not the init values
    path = str(tmp_path / "ckpt" / "params.pt")
    ck.save_params(path, params)
    loaded = ck.load_params(path, like=params if with_like else None, device="cpu")
    want, got = ck.flatten_params(params), ck.flatten_params(loaded)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].device == w.device and torch.equal(got[k], w.detach()), k
        assert got[k].requires_grad == (with_like and w.requires_grad), k


@pytest.mark.parametrize("change", ["missing", "extra", "shape", "dtype"])
def test_load_with_mismatched_like_raises(tmp_path, change):
    cfg = tiny_config()
    params = tc.init_train_state(cfg, device="cpu")[0]
    path = str(tmp_path / "params.pt")
    ck.save_params(path, params)
    like = ck.flatten_params(params)
    if change == "missing":
        like.pop("text.logit_scale")
    elif change == "extra":
        like["text.extra"] = torch.zeros(2)
    elif change == "shape":
        like["vision.cls_token"] = torch.zeros(1, 1, 3)
    else:
        like["vision.cls_token"] = like["vision.cls_token"].detach().to(torch.bfloat16)
    with pytest.raises(ValueError, match="checkpoint"):
        ck.load_params(path, like=ck.unflatten_params(like))


def test_load_with_shardings_raises(tmp_path):
    """Specs without the mesh they name are refused: placing needs it."""
    path = str(tmp_path / "params.pt")
    ck.save_params(path, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="mesh"):
        ck.load_params(path, shardings=object())


def test_training_from_a_loaded_checkpoint_takes_the_same_step(tmp_path):
    """One step, save; then the next step from the live parameters and from
    the loaded ones, each with a fresh optimizer: equal loss, accuracy and
    parameters (max abs 0)."""
    cfg = tiny_config()
    images, tokens = _batch(cfg, 1)
    params, opt = tc.init_train_state(cfg, device="cpu", learning_rate=1e-3)
    tc.make_train_step(cfg, opt, dtype=torch.float32)(params, images, tokens)
    path = str(tmp_path / "params.pt")
    ck.save_params(path, params)
    loaded = ck.load_params(path, like=params)

    results = []
    for tree in (params, loaded):
        p, o = tc.init_train_state(cfg, device="cpu", learning_rate=1e-3, params=tree)
        m = tc.make_train_step(cfg, o, dtype=torch.float32)(p, images, tokens)
        results.append((m, ck.flatten_params(p)))
    (m0, p0), (m1, p1) = results
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["accuracy"], m1["accuracy"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
