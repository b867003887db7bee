"""Expert parallelism (ep): a Switch-style top-1 mixture-of-experts FFN whose
experts shard over the mesh's "model" axis.

Counterpart of hippomm_tpu/parallel/moe.py, its `shard_map` program run over
the mesh's positions in one process (parallel/collectives):

  * routing — each position routes its LOCAL token shard (tokens split over
    "data" on batch and over "model" on sequence) with the replicated router
    in fp32; top-1 expert per token, a fixed per-expert capacity C;
  * dispatch — a (T, E, C) one-hot dispatch tensor turns gather/scatter
    into two einsums, giving (E, C, D) expert slots;
  * all_to_all over "model" — slots travel to the rank owning each expert:
    (E, C, D) -> (E/mp, mp·C, D); the same collective with the axes swapped
    brings the results home. Autograd differentiates through both;
  * expert FFN — one batched einsum pair over the rank's local experts
    (compute-dtype operands, fp32 results), fc2's bias masked to the
    occupied slots;
  * combine — the dispatch tensor weighted by the (differentiable) gate
    value recovers (T, D); a dropped token (capacity overflow) gets zero,
    so callers use the residual form x + moe(x).

The Switch load-balance auxiliary loss comes from the routing statistics
averaged over every position (pmean over "data" and "model").
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from hippomm_tpu_torch.parallel.collectives import all_to_all, reduce_sum
from hippomm_tpu_torch.parallel.mesh import Mesh, Sharded, device_at, positions
from hippomm_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_moe_params(d: int, hidden: int, n_experts: int, generator: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """Router (replicated) + expert FFN stacks (leading (E,) axis, sharded),
    fp32, from `generator` (its device is where they are made; without one,
    seed 0 on `device`, None: CUDA). Expert weights use the torch Linear
    (out, in) convention like models/layers.py."""
    g = generator if generator is not None else torch.Generator(device=resolve_device(device)).manual_seed(0)
    dev = g.device

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return {
        "router_w": 0.02 * normal(d, n_experts),
        "fc1_w": normal(n_experts, hidden, d) / math.sqrt(d),
        "fc1_b": torch.zeros((n_experts, hidden), device=dev),
        "fc2_w": normal(n_experts, d, hidden) / math.sqrt(hidden),
        "fc2_b": torch.zeros((n_experts, d), device=dev),
    }


#: specs: experts shard over "model"; the router is replicated
_MOE_SPECS = {
    "router_w": (None, None),
    "fc1_w": ("model", None, None),
    "fc1_b": ("model", None),
    "fc2_w": ("model", None, None),
    "fc2_b": ("model", None),
}


def moe_specs() -> Dict[str, tuple]:
    return dict(_MOE_SPECS)


def place_moe_params(params: Params, mesh: Mesh, requires_grad: bool = False) -> Dict[str, Sharded]:
    return {k: Sharded.place(torch.as_tensor(v), _MOE_SPECS[k], mesh, requires_grad=requires_grad)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# The expert-parallel program
# ---------------------------------------------------------------------------


def _einsum32(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """einsum of operands rounded to `dtype`, in fp32 (exact products, fp32
    accumulation: JAX's preferred_element_type=float32)."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float())


def _route(router_w: torch.Tensor, x: torch.Tensor, n_experts: int, capacity: int) -> Dict[str, torch.Tensor]:
    """Top-1 routing of x (T, D) in fp32: the gates, the one-hot expert
    choice, and the (T, E, C) dispatch and gate-weighted combine tensors."""
    logits = x.float() @ router_w.float()  # (T, E)
    gates = torch.softmax(logits, dim=-1)
    eidx = torch.argmax(gates, dim=-1)  # (T,), the first of tied maxima
    gate = torch.gather(gates, 1, eidx[:, None])[:, 0]
    onehot = F.one_hot(eidx, n_experts).float()  # (T, E)
    # position of each token within its expert's capacity slots
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1.0  # (T,)
    keep = pos < capacity
    slot = (pos[:, None] == torch.arange(capacity, device=x.device)).float()  # one_hot; 0 past C
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]  # (T, E, C)
    return {"gates": gates, "onehot": onehot, "keep": keep, "dispatch": dispatch,
            "combine": dispatch * gate[:, None, None]}


def _experts(p: Params, slots: torch.Tensor, dtype) -> torch.Tensor:
    """The local experts' FFN on their (E_l, S, D) slots -> (E_l, S, D) fp32
    before fc2's bias."""
    h = _einsum32("ecd,ehd->ech", slots, p["fc1_w"], dtype)
    h = F.gelu(h + p["fc1_b"][:, None, :].float()).to(dtype)
    return _einsum32("ech,edh->ecd", h, p["fc2_w"], dtype)


def moe_block(params: Dict[str, Sharded], x: torch.Tensor, mesh: Mesh, capacity_factor: float = 1.25,
              dtype=torch.bfloat16, stats: Optional[Dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over a ("data", "model") mesh.

    params: place_moe_params leaves. x: (B, T, D) — batch split over "data",
    tokens over "model". B % data, T % model and n_experts % model must all
    be 0. Returns (y (B, T, D) fp32, aux scalar) on x's device; `stats`, when
    given, receives "dropped": the number of tokens past capacity (a tensor).
    Callers use the residual form x + moe_block(...)[0]."""
    n_experts = params["router_w"].shape[1]
    mp, dp = mesh.shape["model"], mesh.shape["data"]
    b, t, d = x.shape
    if n_experts % mp != 0:
        raise ValueError(f"n_experts {n_experts} not divisible by model axis {mp}")
    if b % dp != 0 or t % mp != 0:
        raise ValueError(f"batch {b} / tokens {t} must divide mesh {dp}x{mp}")
    bl, tl = b // dp, t // mp
    capacity = int(math.ceil(capacity_factor * bl * tl / n_experts))
    names = mesh.axis_names
    grid = [[tuple({"data": i, "model": j}.get(a, 0) for a in names) for j in range(mp)] for i in range(dp)]

    routes = {}
    for i, row in enumerate(grid):
        for j, pos in enumerate(row):
            xt = x[i * bl:(i + 1) * bl, j * tl:(j + 1) * tl].to(device_at(mesh, pos)).reshape(-1, d)
            routes[i, j] = (xt, _route(params["router_w"].local(pos), xt, n_experts, capacity))

    # load-balance aux (Switch eq. 4) over the statistics of every position
    first = device_at(mesh, positions(mesh)[0])
    n = len(routes)
    frac = reduce_sum([r["onehot"].mean(dim=0) for _, r in routes.values()], first) / n
    prob = reduce_sum([r["gates"].mean(dim=0) for _, r in routes.values()], first) / n
    aux = n_experts * torch.sum(frac * prob)
    if stats is not None:
        stats["dropped"] = reduce_sum([(~r["keep"]).sum() for _, r in routes.values()], first)

    rows = []
    for i, row in enumerate(grid):
        # dispatch: (Tl, D) -> (E, C, D) -> all_to_all -> (E/mp, mp·C, D)
        slots = [_einsum32("td,tec->ecd", xt, r["dispatch"], dtype).to(dtype)
                 for xt, r in (routes[i, j] for j in range(mp))]
        slots = all_to_all(slots, split_axis=0, concat_axis=1)
        # empty slots must stay zero through fc2's bias: mask by occupancy
        occupied = all_to_all([routes[i, j][1]["dispatch"].sum(dim=0) for j in range(mp)],
                              split_axis=0, concat_axis=1)
        ys = []
        for pos, s, occ in zip(row, slots, occupied):
            p = {k: params[k].local(pos) for k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b")}
            y = (_experts(p, s, dtype) + p["fc2_b"][:, None, :].float()) * occ[:, :, None]
            ys.append(y.to(dtype))
        # home again, (E, C, D), and the gate-weighted combine
        ys = all_to_all(ys, split_axis=1, concat_axis=0)
        outs = [_einsum32("ecd,tec->td", y, routes[i, j][1]["combine"], dtype).reshape(bl, tl, d)
                for j, y in enumerate(ys)]
        rows.append(torch.cat([o.to(x.device) for o in outs], dim=1))
    return torch.cat(rows, dim=0), aux.to(x.device)


# ---------------------------------------------------------------------------
# Single-device oracle (tests): the same math, no collectives
# ---------------------------------------------------------------------------


def moe_reference(params: Params, x: torch.Tensor, capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-math oracle of moe_block at mesh (1, 1), in fp32: routes ALL
    tokens in one group with that group's capacity — callers matching a
    sharded run pass x pre-split into the same device-local groups."""
    b, t, d = x.shape
    xf = x.reshape(-1, d).float()
    n_experts = params["router_w"].shape[1]
    capacity = int(math.ceil(capacity_factor * xf.shape[0] / n_experts))
    r = _route(params["router_w"], xf, n_experts, capacity)
    slots = torch.einsum("td,tec->ecd", xf, r["dispatch"])
    y = _experts(params, slots, torch.float32)
    y = (y + params["fc2_b"][:, None, :].float()) * r["dispatch"].sum(dim=0)[:, :, None]
    out = torch.einsum("ecd,tec->td", y, r["combine"])
    aux = n_experts * torch.sum(r["onehot"].mean(dim=0) * r["gates"].mean(dim=0))
    return out.reshape(b, t, d), aux
