"""The port's expert-parallel Switch MoE (parallel/moe) and its adapter step
(train/contrastive.make_train_step_moe) against the JAX package's on the
8-device CPU mesh (data 2 × model 4), from the same numpy parameters and
inputs, in fp32 (tests/test_moe.py): y and aux within 1e-5 of JAX's
moe_block and of the single-group oracle, the capacity drops, a balanced
aux near 1, gradients against JAX's, the divisibility errors, the adapter
step's three losses within 1e-4, and the sharded checkpoint round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models.imagebind import model as jmodel
from hippomm_tpu.parallel import mesh as jmesh
from hippomm_tpu.parallel import moe as jmoe
from hippomm_tpu.train import contrastive as jc
from hippomm_tpu_torch.models.imagebind import model as tmodel
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.parallel import mesh as tmesh
from hippomm_tpu_torch.parallel import moe as tmoe
from hippomm_tpu_torch.train import checkpoint as ck
from hippomm_tpu_torch.train import contrastive as tc
from torch_parity import assert_close

D, H, E = 32, 64, 8
CPU8 = ["cpu"] * 8



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are tiny, and the suite's workers
    share the host's cores with JAX's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(8, model_parallel=4), tmesh.make_mesh(8, model_parallel=4, devices=CPU8)


def _params(seed: int = 0):
    return jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(seed), D, H, E))


def _x(seed: int, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _both(meshes, p, x, **kw):
    jm, tm = meshes
    yj, auxj = jmoe.moe_block(jmoe.place_moe_params(p, jm), jnp.asarray(x), jm, dtype=jnp.float32, **kw)
    placed = tmoe.place_moe_params({k: torch.tensor(v) for k, v in p.items()}, tm)
    yt, auxt = tmoe.moe_block(placed, torch.tensor(x), tm, dtype=torch.float32, **kw)
    return (np.asarray(yj), float(auxj)), (yt.detach().numpy(), float(auxt))


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_block_matches_jax(request, meshes, cf):
    """y and aux against JAX's moe_block: a generous capacity, and the
    default one (tokens dropped)."""
    (yj, aj), (yt, at) = _both(meshes, _params(), _x(1, (4, 16, D)), capacity_factor=cf)
    assert_close(request, yt, yj, 1e-5, f"moe_y_cf{cf}")
    assert_close(request, at, aj, 1e-5, f"moe_aux_cf{cf}")


def test_moe_matches_single_group_reference(request, meshes):
    """The no-collectives oracle at one token group equals the sharded
    program when capacity is generous, and equals JAX's oracle."""
    p, x = _params(2), _x(3, (2, 8, D))
    (_, _), (yt, _) = _both(meshes, p, x, capacity_factor=16.0)
    yr, ar = tmoe.moe_reference({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), 16.0)
    yjr, ajr = jmoe.moe_reference(p, jnp.asarray(x), capacity_factor=16.0)
    assert_close(request, yt, yr.numpy(), 1e-5, "moe_vs_reference")
    assert_close(request, yr.numpy(), np.asarray(yjr), 1e-5, "reference_vs_jax")
    assert_close(request, float(ar), float(ajr), 1e-5, "reference_aux_vs_jax")


def test_moe_capacity_drops_to_zero_rows(meshes):
    """Every token routed to expert 0 (zero router: all-tie logits, the
    first index wins) with capacity 1: exactly one token a position group
    lands (its first, b-major), every other row is exactly zero, as JAX's;
    the dropped count is the rest."""
    p = _params(4)
    p["router_w"] = np.zeros((D, E), np.float32)
    x = _x(5, (4, 16, D))
    (yj, _), (yt, _) = _both(meshes, p, x, capacity_factor=0.125)
    kept = {(b, t) for b in (0, 2) for t in (0, 4, 8, 12)}
    for b in range(4):
        for t in range(16):
            assert np.any(yt[b, t] != 0.0) == ((b, t) in kept), (b, t)
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    stats = {}
    placed = tmoe.place_moe_params({k: torch.from_numpy(v) for k, v in p.items()}, meshes[1])
    tmoe.moe_block(placed, torch.from_numpy(x), meshes[1], capacity_factor=0.125, dtype=torch.float32, stats=stats)
    assert int(stats["dropped"]) == 4 * 16 - len(kept)


def test_moe_aux_near_one_when_balanced(meshes):
    """Random init routes about uniformly: Switch aux = E·Σ f_e p_e ≈ 1."""
    (_, aj), (_, at) = _both(meshes, _params(6), _x(7, (8, 32, D)), capacity_factor=2.0)
    assert 0.5 < at < 2.0 and abs(at - aj) <= 1e-5


def test_moe_gradients_match_jax(request, meshes):
    """Gradients of mean((y - tgt)²) + 0.01·aux through dispatch,
    all_to_all and combine, and into the router through the gate value and
    the aux, against JAX's; and a few SGD steps reduce the loss."""
    jm, tm = meshes
    p, x, tgt = _params(8), _x(9, (4, 16, D)), _x(10, (4, 16, D))

    def jloss(params):
        y, aux = jmoe.moe_block(params, jnp.asarray(x), jm, capacity_factor=2.0, dtype=jnp.float32)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux

    want = jax.grad(jloss)(jmoe.place_moe_params(p, jm))
    placed = tmoe.place_moe_params({k: torch.from_numpy(v) for k, v in p.items()}, tm, requires_grad=True)

    def tloss(params):
        y, aux = tmoe.moe_block(params, torch.from_numpy(x), tm, capacity_factor=2.0, dtype=torch.float32)
        return ((y - torch.from_numpy(tgt)) ** 2).mean() + 0.01 * aux

    grads = tc.sharded_grads(tloss(placed), placed)
    for k, leaf in placed.items():
        got = np.zeros(leaf.shape, np.float32)
        for (_, bidx), g in grads[k].items():
            got[leaf.block_slices(bidx)] += g.numpy()
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        assert_close(request, got, w, 1e-5, f"moe_grad_{k}", scale=max(float(np.abs(w).max()), 1e-3))
    losses = []
    for _ in range(5):
        loss = tloss(placed)
        losses.append(float(loss.detach()))
        grads = tc.sharded_grads(loss, placed)
        with torch.no_grad():
            for k, leaf in placed.items():
                for key, t in leaf.blocks.items():
                    t -= 0.1 * grads[k][key]
    assert losses[-1] < losses[0], losses


def test_moe_validates_divisibility(meshes):
    _, tm = meshes
    placed = tmoe.place_moe_params({k: torch.from_numpy(v) for k, v in _params().items()}, tm)
    with pytest.raises(ValueError):
        tmoe.moe_block(placed, torch.zeros(4, 15, D), tm)
    p5 = {k: torch.from_numpy(v) for k, v in jax.tree.map(
        np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, 5)).items()}
    bad = dict(placed, router_w=tmesh.Sharded.place(p5["router_w"], (None, None), tm))
    with pytest.raises(ValueError):
        tmoe.moe_block(bad, torch.zeros(4, 16, D), tm)
    assert {k: tuple(v) for k, v in jmoe.moe_specs().items()} == tmoe.moe_specs()


# `isolated` (conftest): a fresh process for a JAX step of collectives over
# 8 virtual CPU devices, whose runtime has aborted a long-lived process;
# the JAX package marks its own adapter test so
@pytest.mark.isolated
def test_moe_adapter_step_matches_jax(request, meshes):
    """The dp × ep adapter step over the frozen tiny towers (8 experts, lr
    3e-3, batch 16) against JAX's make_train_step_moe from the same adapter
    and tower parameters: three losses within 1e-4, finite and falling; the
    balance aux finite; the towers receive no gradient."""
    jm, tm = meshes
    cfg, tcfg = jmodel.tiny_config(), tmodel.tiny_config()
    frozen = jmodel.init_imagebind(jax.random.PRNGKey(0), cfg)
    moe, opt, tx = jc.init_moe_adapter_state(jax.random.PRNGKey(1), cfg, jm, n_experts=8, learning_rate=3e-3)
    moe_np = jax.tree.map(np.asarray, moe)
    frozen_np = jax.tree.map(np.asarray, frozen)
    step = jc.make_train_step_moe(frozen, cfg, jm, tx, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b = 16
    images = rng.normal(size=(b, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(b, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    want = []
    for _ in range(3):
        moe, opt, m = step(moe, opt, images, tokens)
        want.append(float(m["loss"]))
    tfrozen = params_from_jax(frozen_np, tcfg, "cpu", torch.float32)
    tmoe_p, topt = tc.init_moe_adapter_state(tcfg, tm, n_experts=8, learning_rate=3e-3,
                                             params={k: torch.from_numpy(v) for k, v in moe_np.items()})
    tstep = tc.make_train_step_moe(tfrozen, tcfg, tm, topt, dtype=torch.float32)
    got = []
    for _ in range(3):
        m = tstep(tmoe_p, images, tokens)
        got.append(float(m["loss"]))
        assert np.isfinite(float(m["balance"])) and 0 <= int(m["dropped"]) <= b
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(request, g, w, 1e-4, f"adapter_loss{i}")
    assert np.isfinite(got).all() and got[-1] < got[0], got
    assert all(not v.requires_grad or v.grad is None for v in ck.flatten_params(tfrozen).values())


def test_moe_checkpoint_round_trip_sharded(tmp_path, meshes):
    """MoE adapter params (experts split over "model") save whole and load
    into their expert-parallel placement, every block its exact slice."""
    _, tm = meshes
    p = {k: torch.from_numpy(v) for k, v in _params(2).items()}
    placed = tmoe.place_moe_params(p, tm)
    path = str(tmp_path / "moe.pt")
    ck.save_params(path, placed)
    restored = ck.load_params(path, shardings=tmoe.moe_specs(), mesh=tm)
    for k, leaf in restored.items():
        assert leaf.spec == tmoe.moe_specs()[k]
        for (_, bidx), block in leaf.blocks.items():
            assert torch.equal(block, p[k][leaf.block_slices(bidx)]), k
