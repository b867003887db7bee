"""The port's checkpoint loading against the JAX package's, on the CPU:
the vendored ImageBind manifest, `convert_state_dict` / `load_imagebind`
from a `.pth` and a `.safetensors` file written from the manifest (the
towers' features within 1e-5 of the JAX loader's, fp32), the checks that
refuse a wrong checkpoint, and the port's own safetensors reader against
the `safetensors` package, byte for byte, without which the Whisper loader
also reads `model.safetensors`."""

import json
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import save_file as st_save_torch

from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.imagebind import convert as jconvert
from hippomm_tpu.models.imagebind import manifest as jmanifest
from hippomm_tpu.models.imagebind import model as jm
from hippomm_tpu_torch.models import ckpt_io
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.imagebind import convert as tconvert
from hippomm_tpu_torch.models.imagebind import manifest as tmanifest
from hippomm_tpu_torch.models.imagebind import model as tm
from torch_parity import assert_close


def _write(path, sd, fmt):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "pth":
        torch.save(tensors, path)
    else:
        st_save_torch(tensors, path)


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    sd = tmanifest.random_state_dict(tm.tiny_config(), seed=5)
    paths = {"pth": str(root / "imagebind_huge.pth"), "safetensors": str(root / "model.safetensors")}
    for fmt, p in paths.items():
        _write(p, sd, fmt)
    return sd, paths


@pytest.mark.parametrize("variant", ["huge", "tiny"])
def test_manifest_matches_jax(variant):
    got = tmanifest.checkpoint_manifest(tm.get_config(variant))
    want = jmanifest.checkpoint_manifest(jm.get_config(variant))
    assert list(got.items()) == list(want.items())
    assert tconvert.expected_keys(tm.get_config(variant)) == jconvert.expected_keys(jm.get_config(variant))


def test_random_state_dict_follows_the_manifest():
    cfg = tm.tiny_config()
    sd = tmanifest.random_state_dict(cfg, seed=1)
    man = tmanifest.checkpoint_manifest(cfg)
    assert {k: v.shape for k, v in sd.items()} == man
    assert all(v.dtype == np.float32 for v in sd.values())
    again = tmanifest.random_state_dict(cfg, seed=1)
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
    ln = sd["modality_trunks.vision.blocks.0.norm_1.weight"]
    assert abs(float(ln.mean()) - 1.0) < 0.05


def _stacked(tree):
    """The port's tree with each per-layer list stacked: the JAX layout."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return np.stack(tree) if isinstance(tree, list) else tree


def test_convert_state_dict_matches_jax(tiny_ckpts):
    sd, _ = tiny_ckpts
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = jconvert.convert_state_dict(tsd, jm.tiny_config())
    got = tconvert.convert_state_dict(tsd, tm.tiny_config())
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(_stacked(got))
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the block leaves are views of the state_dict, not copies
    w = got["vision"]["blocks"]["mlp"]["fc1"]["weight"][1]
    assert np.shares_memory(w, sd["modality_trunks.vision.blocks.1.mlp.fc1.weight"])
    # the per-layer lists carry to the parameters of the stacked JAX tree
    from hippomm_tpu_torch.models.imagebind.carry import params_from_jax

    cfg = tm.tiny_config()
    a = params_from_jax(want, cfg, "cpu", torch.float32)
    b = params_from_jax(got, cfg, "cpu", torch.float32)
    flat_a, tree_a = jax.tree.flatten(a)
    flat_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b and all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
@pytest.mark.parametrize("by", ["file", "directory"])
def test_load_imagebind_features_match_jax(request, tiny_ckpts, monkeypatch, fmt, by):
    """The wrapper finds the checkpoint (the file, or imagebind_huge.pth /
    model.safetensors in a directory) and loads it without the safetensors
    package; its features equal the JAX wrapper's on the same file."""
    import os

    _, paths = tiny_ckpts
    jib = JImageBind(model_path=paths[fmt], variant="tiny", dtype=jnp.float32)
    if by == "directory":
        # the directory holds both files: the lookup takes imagebind_huge.pth first
        path = os.path.dirname(paths[fmt])
        fmt = "pth"
    else:
        path = paths[fmt]
    monkeypatch.setitem(sys.modules, "safetensors", None)  # a machine without the package
    tib = TImageBind(model_path=path, variant="tiny", dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 90, 120, 3), dtype=np.uint8)
    pcm = (0.2 * rng.standard_normal(3 * 16000)).astype(np.float32)
    texts = ["a red square moves", "what sound plays"]
    assert_close(request, tib.encode_vision(frames), jib.encode_vision(frames), 1e-5, f"vision_{fmt}")
    assert_close(request, tib.encode_audio(pcm), jib.encode_audio(pcm), 1e-5, f"audio_{fmt}")
    assert_close(request, tib.encode_text(texts), jib.encode_text(texts), 1e-5, f"text_{fmt}")


def test_load_imagebind_carries_each_tensor_in_the_compute_dtype(tiny_ckpts):
    _, paths = tiny_ckpts
    params = tconvert.load_imagebind(paths["safetensors"], tm.tiny_config(), "cpu", torch.bfloat16)
    assert params["vision"]["blocks"][1]["mlp"]["fc1"]["weight"].dtype == torch.bfloat16
    assert params["vision"]["blocks"][1]["mlp"]["fc1"]["bias"].dtype == torch.float32
    assert params["text"]["token_embedding"].dtype == torch.float32
    assert len(params["audio"]["blocks"]) == tm.tiny_config().audio.depth
    # the loaded parameters own their memory, not a view of the mapped file
    w = params["text"]["token_embedding"]
    assert w.untyped_storage().nbytes() == w.numel() * 4


def test_bf16_safetensors_checkpoint_loads_as_the_jax_loader_would(tmp_path):
    """A bf16 export: each tensor widens to fp32 on conversion (the JAX
    converter reads numpy, which has no bf16: it gets the widened tensors)."""
    sd = tmanifest.random_state_dict(tm.tiny_config(), seed=2)
    st_save_torch({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                  str(tmp_path / "model.safetensors"))
    loaded = ckpt_io.load_state_dict(str(tmp_path / "model.safetensors"))
    got = _stacked(tconvert.convert_state_dict(loaded, tm.tiny_config()))
    want = jconvert.convert_state_dict({k: v.float() for k, v in loaded.items()}, jm.tiny_config())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["missing", "shape", "deeper"])
def test_validate_state_dict_refuses_as_jax_does(tiny_ckpts, fault):
    sd, _ = tiny_ckpts
    bad = dict(sd)
    if fault == "missing":
        del bad["modality_trunks.audio.blocks.1.mlp.fc2.bias"]
        match = "naming mismatch"
    elif fault == "shape":
        bad["modality_heads.vision.2.weight"] = np.zeros((1024, 32), np.float32)
        match = "shape mismatch"
    else:
        for k, v in sd.items():
            if k.startswith("modality_trunks.text.blocks.1."):
                bad[k.replace("blocks.1.", "blocks.2.")] = v
        match = "depths"
    with pytest.raises(KeyError, match=match) as got:
        tconvert.validate_state_dict(bad, tm.tiny_config())
    with pytest.raises(KeyError) as want:
        jconvert.validate_state_dict(bad, jm.tiny_config())
    assert str(got.value) == str(want.value)
    # the logit scale may be absent (re-exports saved with learnable=False)
    del bad["modality_postprocessors.text.1.log_logit_scale"]
    if fault == "missing":
        with pytest.raises(KeyError, match="naming mismatch"):
            tconvert.validate_state_dict(bad, tm.tiny_config())


def test_infer_depths_matches_jax(tiny_ckpts):
    sd, _ = tiny_ckpts
    assert tconvert.infer_depths(sd) == jconvert.infer_depths(sd) == {"vision": 2, "audio": 2, "text": 2}
    assert tconvert.infer_depths({"x.y": 1}) == jconvert.infer_depths({"x.y": 1}) == {}


def _mixed_tensors():
    rng = np.random.default_rng(9)
    return {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),  # odd: misaligns the next
        "bf16": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.integers(-2**40, 2**40, 5)),
        "i32": torch.from_numpy(rng.integers(-2**20, 2**20, (2, 2)).astype(np.int32)),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 4)),
    }


def test_safetensors_reader_matches_the_package_byte_for_byte(tmp_path):
    p = str(tmp_path / "mixed.safetensors")
    tensors = _mixed_tensors()
    st_save_torch(tensors, p, metadata={"format": "pt"})
    got = ckpt_io.load_safetensors(p)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                          t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert got[k].numpy().tobytes() == t.numpy().tobytes()
    # and against the package's numpy reader for what numpy can hold
    plain = {k: t for k, t in tensors.items() if t.dtype != torch.bfloat16}
    st_save_torch(plain, str(tmp_path / "plain.safetensors"))
    want = st_load_numpy(str(tmp_path / "plain.safetensors"))
    got = ckpt_io.load_state_dict(str(tmp_path / "plain.safetensors"))
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].numpy().tobytes() == v.tobytes()


def _raw_safetensors(path, header: dict, data: bytes):
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + data)


@pytest.mark.parametrize("fault", ["truncated", "overrun", "dtype", "size", "header", "short"])
def test_safetensors_reader_refuses_a_bad_file(tmp_path, fault):
    p = str(tmp_path / "bad.safetensors")
    if fault == "truncated":
        st_save_torch(_mixed_tensors(), p)
        data = open(p, "rb").read()
        open(p, "wb").write(data[: len(data) - 5])
        match = "overrun"
    elif fault == "overrun":
        _raw_safetensors(p, {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
        match = "overrun"
    elif fault == "dtype":
        _raw_safetensors(p, {"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "F64"
    elif fault == "size":
        _raw_safetensors(p, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "needs 12 bytes"
    elif fault == "header":
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", 6) + b"{nope}")
        match = "malformed"
    else:
        with open(p, "wb") as f:
            f.write(struct.pack("<Q", 999) + b"{}")
        match = "overruns"
    with pytest.raises(ValueError, match=match):
        ckpt_io.load_state_dict(p)


def test_whisper_safetensors_loads_without_the_package(tmp_path, monkeypatch):
    """model.safetensors (what current HF snapshots ship) loads through the
    port's reader with the `safetensors` package unimportable, to the same
    parameters as pytorch_model.bin of the same weights."""
    from test_torch_whisper import CFG, _hf_state_dict

    from hippomm_tpu_torch.models.whisper.convert import load_whisper

    sd = {f"model.{k}": v.contiguous() for k, v in _hf_state_dict().items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    st_save_torch(sd, str(tmp_path / "model.safetensors"))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    a = load_whisper(str(tmp_path / "pytorch_model.bin"), CFG, "cpu", torch.float32)
    b = load_whisper(str(tmp_path / "model.safetensors"), CFG, "cpu", torch.float32)
    flat_a, tree_a = jax.tree.flatten(a)
    flat_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b and all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
