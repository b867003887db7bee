"""The port's contrastive training step against the JAX package's.

Both sides start from the JAX `init_train_state(PRNGKey(0), ...)` parameters
(pulled to numpy before the first step, which donates them) and train three
steps on one seeded batch at learning rate 1e-3. Held: each step's loss and
accuracy, the first step's gradients leaf by leaf, every parameter after the
three steps (the audio tower's too, which only weight decay moves), a bf16
step against the JAX bf16 gradients, and the optimizer alone against
optax.adamw.

On the CPU the JAX towers take their plain routes (no Pallas on the CPU
without interpret mode) and the port's kernel wrappers their plain forwards,
so the port's side runs the wrappers' autograd Functions: K1 in the tiny
config; K1 and K2, or K3 and K4 under the fused flags, in a config whose
towers are 128 wide (the K2/K3 gate needs D % 128 == 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hippomm_tpu.models.imagebind import model as jmodel
from hippomm_tpu.parallel.mesh import make_mesh
from hippomm_tpu.train import contrastive as jc
from hippomm_tpu_torch.models import layers as tl
from hippomm_tpu_torch.models.imagebind import model as tmodel
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from hippomm_tpu_torch.train import contrastive as tc
from hippomm_tpu_torch.train.checkpoint import flatten_params
from torch_parity import assert_close

LR, STEPS, BATCH = 1e-3, 3, 8


def _config(mod, name: str):
    cfg = mod.tiny_config()
    if name == "wide":
        tower = mod.TowerConfig(width=128, depth=2, heads=4)
        cfg = dataclasses.replace(cfg, vision=tower, text=tower)
    return cfg


def _batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(BATCH, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(BATCH, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1  # EOS
    return images, tokens


def _by_path(tree_np, tcfg):
    """A JAX tree (numpy leaves, stacked blocks) keyed by the port's paths."""
    return {k: v.numpy() for k, v in flatten_params(params_from_jax(tree_np, tcfg, "cpu", torch.float32)).items()}


@pytest.fixture(scope="module", params=["tiny", "wide"])
def jax_run(request):
    """The JAX side, fp32: initial params, first-step gradients, per-step
    metrics and the params after STEPS steps of make_train_step."""
    name = request.param
    cfg, tcfg = _config(jmodel, name), _config(tmodel, name)
    images, tokens = _batch(cfg)
    mesh = make_mesh(1)
    params, opt_state, tx, shardings = jc.init_train_state(jax.random.PRNGKey(0), cfg, mesh, LR)
    p0 = jax.tree.map(np.asarray, params)
    grads = jax.grad(lambda p: jc.contrastive_loss(p, images, tokens, cfg, jnp.float32)[0])(params)
    step = jc.make_train_step(cfg, mesh, tx, shardings, dtype=jnp.float32)
    metrics = []
    for _ in range(STEPS):
        params, opt_state, m = step(params, opt_state, images, tokens)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"name": name, "cfg": cfg, "tcfg": tcfg, "images": images, "tokens": tokens, "p0": p0,
            "grads": _by_path(jax.tree.map(np.asarray, grads), tcfg), "metrics": metrics,
            "params": _by_path(jax.tree.map(np.asarray, params), tcfg)}


def _port_run(run, monkeypatch, fused: bool):
    """The port's side on the CPU from the same params: the first step's
    gradients, then STEPS steps; under `fused`, the K3/K4 routes (the port's
    policies only: the JAX side keeps its own). Counts the wrapper calls
    that took the autograd route."""
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
                calls[name] = calls.get(name, 0) + 1
            return real(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)

    spy(tl, "flash_mha")
    spy(tl, "fused_mlp")
    spy(tfa, "flash_mha_bthd")
    spy(tfm, "fused_ln_mlp_residual")
    if fused:
        monkeypatch.setattr(tfa, "bthd_default", lambda: True)
        monkeypatch.setattr(tfm, "fused_block_default", lambda: True)
    tcfg = run["tcfg"]
    params, opt = tc.init_train_state(tcfg, device="cpu", learning_rate=LR,
                                      params=params_from_jax(run["p0"], tcfg, "cpu", torch.float32))
    images, tokens = torch.from_numpy(run["images"]), torch.from_numpy(run["tokens"])
    _, grads = tc.loss_and_grads(params, images, tokens, tcfg, torch.float32)
    step = tc.make_train_step(tcfg, opt, dtype=torch.float32)
    metrics = [{k: float(v) for k, v in step(params, images, tokens).items()} for _ in range(STEPS)]
    return {"grads": grads, "metrics": metrics, "calls": calls,
            "params": {k: v.detach().numpy() for k, v in flatten_params(params).items()}}


_ROUTES = {"tiny": [False], "wide": [False, True]}


@pytest.fixture(scope="module")
def runs(jax_run):
    """[(fused, port run)]: the default route, and for the wide towers the
    fused one too."""
    out = []
    for fused in _ROUTES[jax_run["name"]]:
        with pytest.MonkeyPatch.context() as mp:
            out.append((fused, _port_run(jax_run, mp, fused)))
    return out


def test_train_routes_take_the_autograd_functions(jax_run, runs):
    """The tiny towers take K1's Function (vision blocks); the 128-wide ones
    K1 and K2's, or K4 and K3's under the fused flags — one call per block
    (K1/K4 the vision tower's, K2/K3 both towers'), in 1 + STEPS forwards
    (the first step's gradients, then the steps)."""
    depth, forwards = 2, 1 + STEPS
    for fused, run in runs:
        if jax_run["name"] == "tiny":
            want = {"flash_mha": depth * forwards}
        elif fused:
            want = {"flash_mha_bthd": depth * forwards, "fused_ln_mlp_residual": 2 * depth * forwards}
        else:
            want = {"flash_mha": depth * forwards, "fused_mlp": 2 * depth * forwards}
        assert run["calls"] == want, (fused, run["calls"])


def test_train_losses_match_jax(request, jax_run, runs):
    """Each step's loss within 1e-5 (fp32, about 10 ulps of a loss near 2)
    and its accuracy exactly."""
    for fused, run in runs:
        for s, (got, want) in enumerate(zip(run["metrics"], jax_run["metrics"])):
            assert_close(request, got["loss"], want["loss"], 1e-5, f"loss_step{s}_fused{fused}")
            assert got["accuracy"] == want["accuracy"]


def test_train_loss_descends(jax_run, runs):
    """As tests/test_parallel.py asks of the JAX step: the loss falls from the
    first step to the last."""
    for _, run in runs:
        losses = [m["loss"] for m in run["metrics"]]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_first_step_grads_match_jax(request, jax_run, runs):
    """Leaf by leaf, max |port − JAX| ≤ 1e-5 of the tower's largest gradient
    (fp32). The audio tower is outside the loss: no gradient on either side."""
    want = jax_run["grads"]
    for fused, run in runs:
        got = run["grads"]
        assert set(got) == set(want)
        for tower in ("vision", "text"):
            scale = max(np.abs(g).max() for k, g in want.items() if k.startswith(tower))
            for k, g in want.items():
                if k.startswith(tower):
                    assert got[k] is not None and got[k].dtype == torch.float32, k
                    assert_close(request, got[k].numpy(), g, 1e-5, f"grad_{k}_fused{fused}", scale=scale)
        for k, g in want.items():
            if k.startswith("audio"):
                assert got[k] is None and not np.any(g), k


def _updates(run_params, jax_run):
    """(path, port update, JAX update) over STEPS steps, in_proj.bias split
    into its q, k and v thirds."""
    for k, p0 in _by_path(jax_run["p0"], jax_run["tcfg"]).items():
        got, want = run_params[k] - p0, jax_run["params"][k] - p0
        if k.endswith("in_proj.bias"):
            d = p0.shape[0] // 3
            for i, part in enumerate("qkv"):
                yield f"{k}[{part}]", got[i * d:(i + 1) * d], want[i * d:(i + 1) * d]
        else:
            yield k, got, want


def test_params_after_three_steps_match_jax(request, jax_run, runs):
    """Every leaf's update over the three steps, as a relative L2 error:
    ≤ 2e-3 (fp32; Adam divides each gradient by its own RMS, so a component
    near rounding noise moves by a whole step on either side — measured
    ≤ 5e-4). The audio tower's update is weight decay alone: ≤ 1e-5. The key
    bias's true gradient is 0 (the softmax is shift-invariant along the
    keys), so Adam moves it by the sign of each side's rounding noise: only
    its size is held, ≤ lr per step."""
    for fused, run in runs:
        for k, got, want in _updates(run["params"], jax_run):
            if k.endswith("[k]"):
                assert np.abs(got).max() <= LR * STEPS * (1 + 1e-3), k
                continue
            err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            tol = 1e-5 if k.startswith("audio") else 2e-3
            request.node.user_properties.append((f"update_{k}_fused{fused}", f"{err!r} <= {tol!r}"))
            assert err <= tol, (k, err)


def test_audio_tower_moves_by_weight_decay_only(jax_run, runs):
    """optax.adamw decays every leaf, the audio tower's too, whose gradient
    is zero: after n steps each of its leaves is p0·(1 − lr·wd)ⁿ (within
    fp32 rounding, 1e-6 of the leaf's largest value)."""
    p0 = _by_path(jax_run["p0"], jax_run["tcfg"])
    for _, run in runs:
        for k, p in run["params"].items():
            if k.startswith("audio"):
                want = p0[k] * (1 - LR * 0.01) ** STEPS
                assert np.abs(p - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30), k
                assert np.any(p != p0[k]) or not np.any(p0[k]), k


def test_bf16_step_matches_jax_bf16(request):
    """A bf16-compute step (fp32 masters) against the JAX package's bf16
    gradients. The JAX package cannot differentiate its bf16 patchify (the
    transpose of its fp32-accumulating bf16 convolution raises a dtype
    TypeError), so the JAX side holds the patch kernel constant and
    vision.patch_conv is left out. Loss within 2e-3; each leaf's gradient
    within 0.1 relative L2 (bf16 roundings on both sides through two
    blocks; measured ≤ 0.04)."""
    cfg, tcfg = _config(jmodel, "tiny"), _config(tmodel, "tiny")
    images, tokens = _batch(cfg)
    params = jmodel.init_imagebind(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, params)

    def loss(p):
        vision = dict(p["vision"], patch_conv={"weight": jax.lax.stop_gradient(p["vision"]["patch_conv"]["weight"])})
        return jc.contrastive_loss(dict(p, vision=vision), images, tokens, cfg, jnp.bfloat16)

    (want_loss, _), grads = jax.value_and_grad(loss, has_aux=True)(params)
    want = _by_path(jax.tree.map(np.asarray, grads), tcfg)
    tp, _ = tc.init_train_state(tcfg, device="cpu", learning_rate=LR,
                                params=params_from_jax(p0, tcfg, "cpu", torch.float32))
    metrics, got = tc.loss_and_grads(tp, torch.from_numpy(images), torch.from_numpy(tokens), tcfg, torch.bfloat16)
    assert_close(request, float(metrics["loss"]), float(want_loss), 2e-3, "bf16_loss")
    for k, g in want.items():
        if k.startswith("audio") or k == "vision.patch_conv.weight":
            continue
        assert got[k].dtype == torch.float32, k
        err = float(np.linalg.norm(got[k].numpy() - g) / max(np.linalg.norm(g), 1e-30))
        request.node.user_properties.append((f"bf16_grad_{k}", f"{err!r} <= 0.1"))
        assert err <= 0.1, (k, err)
    assert torch.isfinite(got["vision.patch_conv.weight"]).all() and got["vision.patch_conv.weight"].any()


def test_adamw_matches_optax(request):
    """The optimizer alone against optax.adamw(1e-3, weight_decay=0.01) over
    five steps of seeded gradients, one leaf with none (a zero gradient to
    optax): within 1e-7 of the parameters' scale (fp32, a few ulps)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7,), "frozen": (3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adamw(1e-3, weight_decay=0.01)
    jp, state = {k: jnp.asarray(v) for k, v in p0.items()}, None
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = tc.AdamW(tp, 1e-3, weight_decay=0.01)
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32) for k, s in shapes.items()}
        g["frozen"] = np.zeros(shapes["frozen"], np.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {"a": torch.from_numpy(g["a"]), "b": torch.from_numpy(g["b"]), "frozen": None})
    for k in shapes:
        assert_close(request, tp[k].numpy(), np.asarray(jp[k]), 1e-7, f"adamw_{k}",
                     scale=float(np.abs(p0[k]).max()))


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"zero1": True}])
def test_parallel_options_raise(kwargs):
    """A mesh that is not a parallel.mesh.Mesh, and ZeRO-1 without a mesh
    (it splits the moments over the mesh's data axis), are refused, never
    ignored; so is a mesh step over a one-device train state."""
    with pytest.raises(TypeError if "mesh" in kwargs else ValueError, match="mesh"):
        tc.init_train_state(tmodel.tiny_config(), device="cpu", **kwargs)
    params, opt = tc.init_train_state(tmodel.tiny_config(), device="cpu")
    if "mesh" in kwargs:
        with pytest.raises(ValueError, match="init_train_state"):
            tc.make_train_step(tmodel.tiny_config(), opt, mesh=kwargs["mesh"])
