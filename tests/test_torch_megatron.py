"""The port's Megatron TP+SP and GPipe paths (parallel/megatron), the pp
train step (train/contrastive.make_train_step_pp) and the collectives they
and parallel/moe are built on (parallel/collectives), against the JAX
package's on the 8-device CPU mesh.

Both sides start from the same numpy parameters (params_from_jax) and
images, in fp32: the JAX functions on conftest's virtual devices, the
port's on make_mesh(..., devices=["cpu"] * 8). Outputs within atol 1e-5
(tests/test_megatron.py), the pp step's losses within 1e-4, and every
collective's gradient against the JAX transpose of the same collective
(jax.vjp under shard_map) within 1e-6.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from hippomm_tpu.models.imagebind import model as jmodel
from hippomm_tpu.parallel import megatron as JM
from hippomm_tpu.parallel import mesh as jmesh
from hippomm_tpu.train import contrastive as jc
from hippomm_tpu_torch.models import layers as L
from hippomm_tpu_torch.models.imagebind import model as tmodel
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.parallel import collectives as C
from hippomm_tpu_torch.parallel import megatron as M
from hippomm_tpu_torch.parallel import mesh as tmesh
from hippomm_tpu_torch.train import contrastive as tc
from torch_parity import assert_close

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
def tiny():
    cfg, tcfg = jmodel.tiny_config(), tmodel.tiny_config()
    params = jax.tree.map(np.asarray, jmodel.init_imagebind(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    ref = np.asarray(jmodel.vision_forward(params, images, cfg, jnp.float32))
    return cfg, tcfg, params, params_from_jax(params, tcfg, "cpu", torch.float32), images, ref


@pytest.mark.parametrize("mp,remat", [(4, False), (2, True)])
def test_tp_sp_matches_jax(request, tiny, mp, remat):
    """vision_forward_tp_sp at mp 4 (dp 2), and at mp 2 with remat, against
    JAX's on its mesh and the single-device forward: atol 1e-5."""
    cfg, tcfg, params, tparams, images, ref = tiny
    jm = jmesh.make_mesh(model_parallel=mp)
    jplaced = JM.place_tp_params(JM.tp_block_layout(params["vision"]["blocks"]), jm)
    want = np.asarray(JM.vision_forward_tp_sp(params, jplaced, images, cfg, jm, jnp.float32, remat=remat))
    tm = tmesh.make_mesh(8, model_parallel=mp, devices=CPU8)
    placed = M.place_tp_params(M.tp_block_layout(tparams["vision"]["blocks"]), tm)
    assert {k: v.spec for k, v in placed.items()} == {k: tuple(v.sharding.spec) for k, v in jplaced.items()}
    got = M.vision_forward_tp_sp(tparams, placed, images, tcfg, tm, torch.float32, remat=remat).detach().numpy()
    assert_close(request, got, want, 1e-5, f"tp_sp_mp{mp}")
    assert_close(request, got, ref, 1e-5, f"tp_sp_mp{mp}_vs_single")


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_2x2x2_matches_jax(request, tiny, n_micro):
    """vision_forward_pp on (data 2, pipe 2, model 2) against JAX's and the
    single-device forward: atol 1e-5."""
    cfg, tcfg, params, tparams, images, ref = tiny
    jm = jmesh.make_mesh(model_parallel=2, pipeline_parallel=2)
    jstaged = JM.place_tp_params(JM.add_stage_axis(JM.tp_block_layout(params["vision"]["blocks"]), 2), jm,
                                 staged=True)
    want = np.asarray(JM.vision_forward_pp(params, jstaged, images, cfg, jm, n_micro=n_micro, dtype=jnp.float32))
    tm = tmesh.make_mesh(8, model_parallel=2, pipeline_parallel=2, devices=CPU8)
    assert tm.shape == {"data": 2, "pipe": 2, "model": 2}
    staged = M.place_tp_params(M.add_stage_axis(M.tp_block_layout(tparams["vision"]["blocks"]), 2), tm, staged=True)
    got = M.vision_forward_pp(tparams, staged, images, tcfg, tm, n_micro=n_micro, dtype=torch.float32)
    assert_close(request, got.detach().numpy(), want, 1e-5, f"pp_2x2x2_m{n_micro}")
    assert_close(request, got.detach().numpy(), ref, 1e-5, f"pp_2x2x2_m{n_micro}_vs_single")


def test_pipeline_four_stages_matches_jax(request):
    """pipe 4 with a depth-4 tower: one block per stage, dp 1 × pp 4 × tp 2,
    n_micro 3 (batch 6)."""
    tower = jmodel.TowerConfig(width=64, depth=4, heads=4)
    cfg = jmodel.ImageBindConfig(vision=tower, audio=jmodel.TowerConfig(width=48, depth=2, heads=4),
                                 text=jmodel.TowerConfig(width=64, depth=2, heads=4), image_size=56, patch_size=14,
                                 vocab_size=512, context_length=16)
    tcfg = tmodel.ImageBindConfig(vision=tmodel.TowerConfig(width=64, depth=4, heads=4),
                                  audio=tmodel.TowerConfig(width=48, depth=2, heads=4),
                                  text=tmodel.TowerConfig(width=64, depth=2, heads=4), image_size=56,
                                  patch_size=14, vocab_size=512, context_length=16)
    params = jax.tree.map(np.asarray, jmodel.init_imagebind(jax.random.PRNGKey(1), cfg))
    images = np.random.default_rng(1).normal(size=(6, 3, 56, 56)).astype(np.float32)
    jm = jmesh.make_mesh(model_parallel=2, pipeline_parallel=4)
    jstaged = JM.place_tp_params(JM.add_stage_axis(JM.tp_block_layout(params["vision"]["blocks"]), 4), jm,
                                 staged=True)
    want = np.asarray(JM.vision_forward_pp(params, jstaged, images, cfg, jm, n_micro=3, dtype=jnp.float32))
    tparams = params_from_jax(params, tcfg, "cpu", torch.float32)
    tm = tmesh.make_mesh(8, model_parallel=2, pipeline_parallel=4, devices=CPU8)
    staged = M.place_tp_params(M.add_stage_axis(M.tp_block_layout(tparams["vision"]["blocks"]), 4), tm, staged=True)
    got = M.vision_forward_pp(tparams, staged, images, tcfg, tm, n_micro=3, dtype=torch.float32)
    assert_close(request, got.detach().numpy(), want, 1e-5, "pp_four_stages")


def test_pipeline_grads_flow_and_match_jax(request, tiny):
    """Gradients flow through ppermute / all_gather / psum_scatter: those of
    Σ e·tgt over the staged leaves equal JAX's (1e-5 of the largest) and
    are not all zero."""
    cfg, tcfg, params, tparams, images, _ = tiny
    tgt = np.random.default_rng(2).normal(size=(8, cfg.embed_dim)).astype(np.float32)
    jm = jmesh.make_mesh(model_parallel=2, pipeline_parallel=2)
    jstaged = JM.place_tp_params(JM.add_stage_axis(JM.tp_block_layout(params["vision"]["blocks"]), 2), jm,
                                 staged=True)
    want = jax.grad(lambda b: jnp.sum(JM.vision_forward_pp(params, b, images, cfg, jm, n_micro=2,
                                                           dtype=jnp.float32) * tgt))(jstaged)
    tm = tmesh.make_mesh(8, model_parallel=2, pipeline_parallel=2, devices=CPU8)
    staged = M.place_tp_params(M.add_stage_axis(M.tp_block_layout(tparams["vision"]["blocks"]), 2), tm,
                               staged=True, requires_grad=True)
    e = M.vision_forward_pp(tparams, staged, images, tcfg, tm, n_micro=2, dtype=torch.float32)
    (e * torch.from_numpy(tgt)).sum().backward()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert scale > 1e-3
    for k, leaf in staged.items():
        got = np.zeros(leaf.shape, np.float32)
        for (_, bidx), t in leaf.blocks.items():
            got[leaf.block_slices(bidx)] += t.grad.numpy()
        assert_close(request, got, np.asarray(want[k]), 1e-5, f"pp_grad_{k}", scale=scale)


# `isolated` (conftest): a fresh process for a JAX step of collectives over
# 8 virtual CPU devices, whose runtime has aborted a long-lived process;
# the JAX package marks its own pp trajectory test so
@pytest.mark.isolated
def test_pp_train_step_matches_jax(request):
    """Three steps of the dp×pp×tp×sp train step (data 2, pipe 2, model 2,
    n_micro 2) against JAX's make_train_step_pp from the same parameters:
    losses within 1e-4 and finite (at lr 1e-3 JAX's own trajectory here
    does not fall monotonically: 2.103, 1.997, 2.277)."""
    cfg, tcfg = jmodel.tiny_config(), tmodel.tiny_config()
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(8, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    jm = jmesh.make_mesh(model_parallel=2, pipeline_parallel=2)
    sp, opt, tx, sh = jc.init_train_state_pp(jax.random.PRNGKey(0), cfg, jm, 1e-3)
    p0 = jax.tree.map(np.asarray, jmodel.init_imagebind(jax.random.PRNGKey(0), cfg))
    step = jc.make_train_step_pp(cfg, jm, tx, sh, n_micro=2, dtype=jnp.float32)
    want = []
    for _ in range(3):
        sp, opt, m = step(sp, opt, images, tokens)
        want.append(float(m["loss"]))
    tm = tmesh.make_mesh(8, model_parallel=2, pipeline_parallel=2, devices=CPU8)
    state, topt = tc.init_train_state_pp(tcfg, tm, 1e-3, params=params_from_jax(p0, tcfg, "cpu", torch.float32))
    assert {k: v.spec for k, v in state["blocks"].items()} == M.tp_specs(staged=True)
    tstep = tc.make_train_step_pp(tcfg, tm, topt, n_micro=2, dtype=torch.float32)
    got = [float(tstep(state, images, tokens)["loss"]) for _ in range(3)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(request, g, w, 1e-4, f"pp_step_loss{i}")
    assert np.isfinite(got).all(), got


def test_bias_kv_blocks_rejected(tiny):
    with pytest.raises(NotImplementedError):
        M.tp_block_layout(tiny[3]["audio"]["blocks"])


def test_stage_axis_divisibility(tiny):
    packed = M.tp_block_layout(tiny[3]["vision"]["blocks"])
    with pytest.raises(ValueError):
        M.add_stage_axis(packed, 3)  # depth 2 not divisible


@pytest.mark.parametrize("route", ["1", "0", "bthd"])
def test_token_padding_helpers(monkeypatch, route):
    """_padded_tokens as JAX's; and attention with k/v over the first
    t_valid tokens (layers.attention's kv_rows, which the padded blocks use
    in place of JAX's _token_mask) equals the softmax under JAX's -inf key
    mask on every row, through K1's, the plain and K4's route: 1e-6."""
    assert M._padded_tokens(257, 2) == 258 and M._padded_tokens(257, 1) == 257
    assert JM._token_mask(5, 5) is None
    monkeypatch.setenv("HIPPOMM_FLASH_ATTN", "0" if route == "0" else "1")
    monkeypatch.setenv("HIPPOMM_FLASH_BTHD", "1" if route == "bthd" else "0")
    rng = np.random.default_rng(3)
    b, t_valid, t_pad, d, heads = 2, 5, 6, 16, 2
    x = rng.normal(size=(b, t_pad, d)).astype(np.float32)
    w_in, b_in = rng.normal(size=(3 * d, d)).astype(np.float32), rng.normal(size=3 * d).astype(np.float32)
    w_out = rng.normal(size=(d, d)).astype(np.float32)
    p = {"in_proj": {"weight": torch.from_numpy(w_in), "bias": torch.from_numpy(b_in)},
         "out_proj": {"weight": torch.from_numpy(w_out)}}
    got = L.attention(p, torch.from_numpy(x), num_heads=heads, dtype=torch.float32, kv_rows=t_valid).numpy()
    q, k, v = np.split(x @ w_in.T + b_in, 3, axis=-1)
    q, k, v = (y.reshape(b, t_pad, heads, d // heads).transpose(0, 2, 1, 3) for y in (q, k, v))
    logits = q @ k.transpose(0, 1, 3, 2) / np.sqrt(d // heads) + np.asarray(JM._token_mask(t_valid, t_pad))
    wts = np.exp(logits - logits.max(-1, keepdims=True))
    want = ((wts / wts.sum(-1, keepdims=True)) @ v).transpose(0, 2, 1, 3).reshape(b, t_pad, d) @ w_out.T
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------- collectives

_N = 8


def _jax_vjp(fn, x, ct, transpose=None):
    """JAX's value of `fn` under shard_map over 8 devices and the transpose
    of the cotangent: jax.vjp's, or `transpose` applied under shard_map."""
    mesh = JMesh(np.array(jax.devices()[:_N]), ("x",))
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("x"), out_specs=P("x"))
    if transpose is not None:
        t = jax.shard_map(transpose, mesh=mesh, in_specs=P("x"), out_specs=P("x"))
        return np.asarray(f(jnp.asarray(x))), np.asarray(t(jnp.asarray(ct)))
    out, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _port_vjp(fn, x, ct):
    """fn over the 8 per-rank chunks of x (leading axis); the outputs and
    the cotangent's 8 chunks paired rank by rank."""
    parts = [p.clone().requires_grad_(True) for p in torch.from_numpy(x).chunk(_N)]
    outs = fn(parts)
    cts = torch.from_numpy(ct).chunk(_N)
    sum(((o * c).sum() for o, c in zip(outs, cts)), torch.zeros(())).backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in parts]  # an unread rank
    return torch.cat([o.detach() for o in outs]).numpy(), torch.cat(grads).detach().numpy()


_COLLECTIVES = {
    "all_gather": (partial(jax.lax.all_gather, axis_name="x", axis=1, tiled=True),
                   lambda ps: C.all_gather(ps, axis=1, tiled=True), (3, 2)),
    "all_gather_stacked": (partial(jax.lax.all_gather, axis_name="x", axis=1, tiled=False),
                           lambda ps: C.all_gather(ps, axis=1, tiled=False), (3, 2)),
    "psum_scatter": (partial(jax.lax.psum_scatter, axis_name="x", scatter_dimension=1, tiled=True),
                     lambda ps: C.psum_scatter(ps, scatter_dimension=1, tiled=True), (2, 16)),
    "psum_scatter_untiled": (partial(jax.lax.psum_scatter, axis_name="x", scatter_dimension=1, tiled=False),
                             lambda ps: C.psum_scatter(ps, scatter_dimension=1, tiled=False), (2, 8, 3)),
    "psum": (partial(jax.lax.psum, axis_name="x"), C.psum, (2, 3)),
    "pmean": (partial(jax.lax.pmean, axis_name="x"), C.pmean, (2, 3)),
    "ppermute": (partial(jax.lax.ppermute, axis_name="x", perm=[(i, (i + 3) % _N) for i in range(_N)]),
                 lambda ps: C.ppermute(ps, [(i, (i + 3) % _N) for i in range(_N)]), (2, 3)),
    "ppermute_partial": (partial(jax.lax.ppermute, axis_name="x", perm=[(0, 1), (1, 2), (5, 0)]),
                         lambda ps: C.ppermute(ps, [(0, 1), (1, 2), (5, 0)]), (2, 3)),
    "all_to_all": (partial(jax.lax.all_to_all, axis_name="x", split_axis=1, concat_axis=0, tiled=True),
                   lambda ps: C.all_to_all(ps, split_axis=1, concat_axis=0, tiled=True), (2, 16)),
    # this JAX release's vjp of the untiled all_to_all fails its own
    # cotangent type check, so the reference gradient is its transpose
    # rule applied directly: the all_to_all with the axes swapped
    "all_to_all_untiled": (partial(jax.lax.all_to_all, axis_name="x", split_axis=1, concat_axis=0, tiled=False),
                           lambda ps: C.all_to_all(ps, split_axis=1, concat_axis=0, tiled=False), (2, 8, 3),
                           partial(jax.lax.all_to_all, axis_name="x", split_axis=0, concat_axis=1, tiled=False)),
}


@pytest.mark.parametrize("name", sorted(_COLLECTIVES))
def test_collective_and_its_gradient_match_jax(request, name):
    """Each collective's value and the gradient autograd derives for it,
    against the JAX collective and its transpose (jax.vjp under shard_map
    over 8 devices), with a random cotangent per rank."""
    jfn, tfn, local, *transpose = _COLLECTIVES[name]
    rng = np.random.default_rng(sorted(_COLLECTIVES).index(name))
    x = rng.normal(size=(_N * local[0],) + local[1:]).astype(np.float32)
    out_local = tfn(list(torch.from_numpy(x).chunk(_N)))[0].shape
    ct = rng.normal(size=(_N * out_local[0],) + tuple(out_local[1:])).astype(np.float32)
    want_out, want_grad = _jax_vjp(jfn, x, ct, *transpose)
    got_out, got_grad = _port_vjp(tfn, x, ct)
    assert_close(request, got_out, want_out, 1e-6, f"{name}_value")
    assert_close(request, got_grad, want_grad, 1e-6, f"{name}_grad")
