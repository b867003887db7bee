"""Collectives over the shards of one mesh axis, in one process.

Counterparts of the `jax.lax` collectives that parallel/megatron.py and
parallel/moe.py call inside `shard_map`. JAX runs one program per device and
names the axis; here one process holds the shards of the axis as a list, in
rank order, each tensor on its rank's device, and every function returns the
list of the ranks' results, each on its rank's device:

  * `all_gather(parts, axis, tiled)`        — lax.all_gather
  * `psum_scatter(parts, dim, tiled)`       — lax.psum_scatter
  * `psum(parts)`, `pmean(parts)`           — lax.psum / lax.pmean
    (`reduce_sum(parts, device)`: the sum where one rank reads it)
  * `ppermute(parts, perm)`                 — lax.ppermute
  * `all_to_all(parts, split, concat, tiled)` — lax.all_to_all

Each is plain differentiable torch (`.to(device)`, `torch.cat`, sums,
`chunk`), so autograd derives the transpose JAX's rules give: all_gather's
is psum_scatter, psum's is psum, ppermute's is the inverse permutation,
all_to_all's is all_to_all with the axes swapped. No autograd Function is
needed.

Ranks that share a device (a mesh of several shards on one card) share one
result tensor where the result is the same for all of them (all_gather,
psum), so the work is done once per device; autograd then sums their
gradients, which is the transpose's sum over those ranks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def _per_device(parts: Sequence[torch.Tensor], make) -> List[torch.Tensor]:
    """make(device) once per distinct device of `parts`, handed to every
    rank on that device."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        if p.device not in done:
            done[p.device] = make(p.device)
        out.append(done[p.device])
    return out


def reduce_sum(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ tensors on `device`, in list order: a psum's value where only one
    rank reads it."""
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


def all_gather(parts: Sequence[torch.Tensor], axis: int = 0, tiled: bool = True) -> List[torch.Tensor]:
    """Every rank gets the ranks' parts concatenated along `axis` (tiled) or
    stacked on a new `axis` (not tiled)."""
    join = torch.cat if tiled else torch.stack
    return _per_device(parts, lambda dev: join([p.to(dev) for p in parts], dim=axis))


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank gets the sum of the ranks' parts."""
    return _per_device(parts, lambda dev: reduce_sum(parts, dev))


def pmean(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank gets the mean of the ranks' parts."""
    n = len(parts)
    return [t / n for t in psum(parts)]


def psum_scatter(parts: Sequence[torch.Tensor], scatter_dimension: int = 0,
                 tiled: bool = True) -> List[torch.Tensor]:
    """Rank k gets the sum over ranks of chunk k of `scatter_dimension`
    (tiled: the dimension splits into n equal chunks; not tiled: its size is
    n and it is removed)."""
    n = len(parts)
    dim = scatter_dimension
    if parts[0].shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size {parts[0].shape[dim]} does not split "
                         f"over {n} ranks")
    if not tiled and parts[0].shape[dim] != n:
        raise ValueError(f"psum_scatter(tiled=False): dimension {dim} must have size {n}")
    out = []
    for k, p in enumerate(parts):
        chunks = [q.chunk(n, dim=dim)[k] for q in parts]
        total = reduce_sum(chunks, p.device)
        out.append(total if tiled else total.squeeze(dim))
    return out


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Rank `dst` gets rank `src`'s part for each (src, dst) of `perm`; a
    rank that receives nothing gets zeros, as lax.ppermute gives it."""
    out = [None] * len(parts)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: rank {dst} receives twice")
        out[dst] = parts[src].to(parts[dst].device)
    return [torch.zeros_like(p) if o is None else o for p, o in zip(parts, out)]


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               tiled: bool = True) -> List[torch.Tensor]:
    """Rank k gets chunk k of every rank's `split_axis`, in rank order,
    concatenated along `concat_axis` (tiled; the split axis divides into n
    chunks). Not tiled, the split axis has size n and is removed, and the
    received slices stack on a new `concat_axis`."""
    n = len(parts)
    if parts[0].shape[split_axis] % n or (not tiled and parts[0].shape[split_axis] != n):
        raise ValueError(f"all_to_all: split axis {split_axis} of size {parts[0].shape[split_axis]} "
                         f"over {n} ranks")
    out = []
    for k, p in enumerate(parts):
        if tiled:
            out.append(torch.cat([q.chunk(n, dim=split_axis)[k].to(p.device) for q in parts], dim=concat_axis))
        else:
            out.append(torch.stack([q.select(split_axis, k).to(p.device) for q in parts], dim=concat_axis))
    return out
