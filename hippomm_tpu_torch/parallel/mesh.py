"""Device meshes, sharding rules and sharded tensors.

Counterpart of hippomm_tpu/parallel/mesh.py. JAX drives every local chip
from one process through one `Mesh`; here one process drives a grid of
torch devices the same way:

  * `make_mesh` gives JAX's axis names and shapes: ("data", "model"), with
    a "pipe" axis for pipeline_parallel > 1 and a leading "replica" axis for
    dcn_replicas > 1;
  * weights are copied once to each distinct device that runs a shard
    (`replicate`): a mesh whose shards share one card holds one copy;
  * a batch splits over replica × data (`shard_batch`), each shard runs on
    its device, and the small results come back to the mesh's first device
    (`gather`). A batch whose leading axis does not divide runs whole on the
    first device, as JAX runs an indivisible batch replicated.

The serving path has no tensor parallelism: JAX's serving towers replicate
their weights over the whole mesh, "model" included, so a mesh's model and
pipe axes only repeat the work. Shards run at index 0 of those axes.

Training shards its state. A spec is JAX's PartitionSpec as a tuple: one
entry per dimension, None (whole), an axis name, or a tuple of axis names
(split over their product, the first outermost). `param_shardings` gives
JAX's tensor-parallel rules, `zero1_shardings` / `zero1_opt_shardings` its
ZeRO-1 placement of the AdamW moments, `data_sharding` the batch's spec.
`Sharded` holds one tensor per (device, block) that the spec and the mesh
give: a block that several mesh positions on one device hold is stored once
(a mesh of shards on one card holds each replicated leaf once), and a block
held on several devices is a copy on each. `shard_tree` / `unshard_tree`
place a tree of tensors and gather it back. No `torch.distributed` is
needed: one process reaches every device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceSpec = Union[str, torch.device]


def canonical_device(device: DeviceSpec) -> torch.device:
    """A torch.device with its index filled in ("cuda" → cuda:<current>),
    so that equal devices compare equal as dictionary keys."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(devices: Optional[Sequence[DeviceSpec]] = None,
                  device: Optional[DeviceSpec] = None) -> List[torch.device]:
    """The devices a mesh may span: `devices` when the caller gives them (a
    device may repeat: several shards on one card); else just `device` when
    the caller names one, so that an explicit device pins the engine to it;
    else every CUDA device of this host, the counterpart of
    `jax.devices()`."""
    if devices is not None:
        return [canonical_device(d) for d in devices]
    if device is not None:
        return [canonical_device(device)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of torch devices with named axes, like jax.sharding.Mesh:
    `devices` is an object array of torch.device whose shape is the axes'
    sizes, `shape` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence[DeviceSpec]] = None,
    pipeline_parallel: int = 1,
    dcn_replicas: int = 1,
) -> Mesh:
    """("data", "model") mesh over the local devices, or ("data", "pipe",
    "model") with pipeline_parallel > 1, with a leading "replica" axis when
    dcn_replicas > 1. model_parallel × pipeline_parallel × dcn_replicas must
    divide the device count (ValueError); "data" gets the rest. Devices are
    laid out in order, "model" innermost and "replica" outermost, as in the
    JAX package."""
    devs = local_devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % (model_parallel * pipeline_parallel * dcn_replicas) != 0:
        raise ValueError(
            f"model_parallel={model_parallel} x pipeline_parallel="
            f"{pipeline_parallel} x dcn_replicas={dcn_replicas} "
            f"must divide device count {n}"
        )
    grid = np.empty((n,), dtype=object)
    grid[:] = devs
    inner = n // dcn_replicas
    if pipeline_parallel > 1:
        shape = (inner // (model_parallel * pipeline_parallel), pipeline_parallel, model_parallel)
        names = ("data", "pipe", "model")
    else:
        shape = (inner // model_parallel, model_parallel)
        names = ("data", "model")
    if dcn_replicas > 1:
        return Mesh(grid.reshape((dcn_replicas,) + shape), ("replica",) + names)
    return Mesh(grid.reshape(shape), names)


def data_axis_size(mesh: Mesh) -> int:
    """Ways the batch axis splits: data × replica on a multi-slice mesh.
    Divisibility gates use this, not mesh.shape["data"] alone."""
    n = mesh.shape["data"]
    if "replica" in mesh.axis_names:
        n *= mesh.shape["replica"]
    return n


def _at(mesh: Mesh, fixed: Dict[str, int]) -> List[torch.device]:
    """Devices along the replica and data axes (replica-major), at index 0
    of every other axis, except those `fixed` pins."""
    index = tuple(slice(None) if a in ("replica", "data") and a not in fixed else fixed.get(a, 0)
                  for a in mesh.axis_names)
    return list(mesh.devices[index].reshape(-1))


def batch_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each batch shard, in shard order: replica-major, then
    data (JAX's data_sharding over ("replica", "data"))."""
    return _at(mesh, {})


def data_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each "data" shard of a store (JAX's P("data", None)),
    on the first replica."""
    return _at(mesh, {"replica": 0} if "replica" in mesh.axis_names else {})


def first_device(mesh: Mesh) -> torch.device:
    """Where a mesh's small results gather and indivisible batches run."""
    return batch_devices(mesh)[0]


def replicate(tree, mesh: Mesh) -> Dict[torch.device, object]:
    """One copy of a tree of tensors (nested dicts, lists, tuples) per
    distinct device that runs a batch shard, keyed by device. A leaf already
    on a device is that copy, not a new one, so shards sharing a card share
    its weights."""

    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to(v, dev) for v in x)
        return x

    return {dev: to(tree, dev) for dev in dict.fromkeys(batch_devices(mesh))}


def shard_batch(x, mesh: Mesh) -> Optional[List[torch.Tensor]]:
    """Split an array or tensor along its leading axis into data_axis_size
    equal slabs, each moved to its shard's device; None when the leading
    axis does not divide (the caller runs the whole batch on the first
    device)."""
    n = data_axis_size(mesh)
    if x.shape[0] % n:
        return None
    x = torch.as_tensor(x)
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(dev) for i, dev in enumerate(batch_devices(mesh))]


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' results, in shard order, concatenated on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# Sharding rules (tensor parallelism of the transformer stacks, ZeRO-1)
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]

# torch Linear convention W (out, in), as the JAX rules:
#   fc1 / in_proj / q,k,v: shard the OUT dim  -> heads / hidden split over "model"
#   fc2 / out_proj:        shard the IN dim   -> a psum after the second product
# The port's blocks are a per-layer list, so a block leaf has no leading
# depth axis: its spec is JAX's without the leading None.


def _spec_for(path: str, ndim: int) -> Spec:
    def pad(tail):
        full = tuple(tail)[:ndim]
        return full + (None,) * (ndim - len(full))

    if any(k in path for k in ("fc1", "in_proj", "q_proj", "k_proj", "v_proj")):
        if path.endswith("weight") and ndim >= 2:
            return pad(("model", None))
        if path.endswith("bias"):
            return pad(("model",))
    if any(k in path for k in ("fc2", "out_proj")):
        if path.endswith("weight") and ndim >= 2:
            return pad((None, "model"))
        if path.endswith("bias"):
            return pad((None,))
    # embeddings / norms / convs / heads: replicated
    return (None,) * ndim


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) over nested dicts and lists, in order; a leaf is a
    tensor, a Sharded, an array or a number."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def _map(tree, fn, prefix: str = ""):
    """fn(path, leaf) over the leaves of `tree`, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}.{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_map(v, fn, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def param_shardings(params, mesh: Mesh):
    """The tree of specs of JAX's tensor-parallel rules, with its guard: a
    leaf whose "model" dimension the model axis does not divide is
    replicated."""
    msize = mesh.shape["model"]

    def one(path, leaf):
        dims = _shape(leaf)
        spec = _spec_for(path, len(dims))
        if any(name == "model" and dims[i] % msize for i, name in enumerate(spec)):
            return (None,) * len(dims)
        return spec

    return _map(params, one)


def zero1_shardings(params, mesh: Mesh):
    """ZeRO-1 specs of the AdamW moments: each leaf keeps its TP spec and
    splits its first still-unsharded dimension that "data" divides over
    "data" (never the "replica" axis: moments replicate across slices)."""
    dsize = mesh.shape["data"]
    base = param_shardings(params, mesh)
    flat_base = dict(tree_leaves(base))

    def one(path, leaf):
        dims = _shape(leaf)
        spec = list(flat_base[path]) + [None] * (len(dims) - len(flat_base[path]))
        for i, d in enumerate(dims):
            if spec[i] is None and d % dsize == 0 and d >= dsize:
                spec[i] = "data"
                break
        return tuple(spec)

    return _map(params, one)


def zero1_opt_shardings(opt_state, params, mesh: Mesh):
    """Specs for an optimizer state tree mirroring `zero1_shardings`: a
    state leaf whose path ends in a parameter's path (the moments,
    `mu.vision.blocks.0...`) takes that parameter's ZeRO-1 spec; any other
    leaf (the step count) is replicated, ()."""
    by_path = dict(tree_leaves(zero1_shardings(params, mesh)))

    def one(path, leaf):
        keys = path.split(".")
        for start in range(len(keys)):
            spec = by_path.get(".".join(keys[start:]))
            if spec is not None and len(spec) <= len(_shape(leaf)):
                return spec
        return ()

    return _map(opt_state, one)


def data_sharding(mesh: Mesh, ndim: int) -> Spec:
    """The batch's spec: the leading axis over "data", or over ("replica",
    "data") on a multi-slice mesh."""
    lead = ("replica", "data") if "replica" in mesh.axis_names else "data"
    return (lead,) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# Sharded tensors
# ---------------------------------------------------------------------------


def positions(mesh: Mesh) -> List[Tuple[int, ...]]:
    """Every mesh position (an index into mesh.devices), in row-major order."""
    return list(np.ndindex(*mesh.devices.shape))


def device_at(mesh: Mesh, pos: Tuple[int, ...]) -> torch.device:
    return mesh.devices[pos]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharded:
    """A global tensor of `shape` split over mesh axes by `spec`. `blocks`
    maps (device, block index) to that block's tensor; a block index holds
    one chunk number per dimension. Every mesh position holds the block its
    coordinates give, on its device."""

    def __init__(self, mesh: Mesh, spec: Spec, shape: Sequence[int],
                 blocks: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor]):
        self.mesh, self.shape = mesh, tuple(shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.blocks = blocks
        for i, e in enumerate(self.spec):
            n = self.chunks(i)
            if self.shape[i] % n:
                raise ValueError(f"spec {self.spec}: dimension {i} of {self.shape} does not split {n} ways")

    def chunks(self, dim: int) -> int:
        return int(np.prod([self.mesh.shape[a] for a in _axes(self.spec[dim])], dtype=np.int64))

    def block_index(self, pos: Tuple[int, ...]) -> Tuple[int, ...]:
        coords = dict(zip(self.mesh.axis_names, pos))
        out = []
        for e in self.spec:
            idx = 0
            for a in _axes(e):
                idx = idx * self.mesh.shape[a] + coords[a]
            out.append(idx)
        return tuple(out)

    def block_slices(self, bidx: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The global index ranges of block `bidx`."""
        out = []
        for i, b in enumerate(bidx):
            size = self.shape[i] // self.chunks(i)
            out.append(slice(b * size, (b + 1) * size))
        return tuple(out)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def local(self, pos: Tuple[int, ...]) -> torch.Tensor:
        """The block mesh position `pos` holds, on its device."""
        return self.blocks[(device_at(self.mesh, pos), self.block_index(pos))]

    def _any(self, bidx, device: torch.device) -> torch.Tensor:
        """Block `bidx`, the copy on `device` where there is one."""
        t = self.blocks.get((device, bidx))
        if t is not None:
            return t
        return next(v for (d, b), v in self.blocks.items() if b == bidx).to(device)

    def take(self, pos: Tuple[int, ...], dim: int, start: int, stop: int) -> torch.Tensor:
        """Global indices [start, stop) of `dim`, and `pos`'s block of every
        other dimension, on `pos`'s device, cut from the blocks that hold
        them (differentiable)."""
        dev = device_at(self.mesh, pos)
        bidx = list(self.block_index(pos))
        size = self.shape[dim] // self.chunks(dim)
        pieces = []
        for b in range(start // size, (stop - 1) // size + 1):
            bidx[dim] = b
            block = self._any(tuple(bidx), dev)
            lo, hi = max(start, b * size) - b * size, min(stop, (b + 1) * size) - b * size
            pieces.append(block.narrow(dim, lo, hi - lo))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)

    def full(self, device: DeviceSpec) -> torch.Tensor:
        """The whole tensor on `device`, concatenated from the blocks
        (differentiable)."""
        device = canonical_device(device)
        counts = [self.chunks(i) for i in range(len(self.shape))]

        def build(prefix):
            dim = len(prefix)
            if dim == len(self.shape):
                return self._any(tuple(prefix), device)
            parts = [build(prefix + [b]) for b in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

        return build([])

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, {self.spec}, {len(self.blocks)} blocks)"

    @staticmethod
    def _filled(shape: Sequence[int], spec: Spec, mesh: Mesh, make) -> "Sharded":
        """make(device, block slices) once per (device, block) of the mesh."""
        out = Sharded(mesh, spec, shape, {})
        for pos in positions(mesh):
            key = (device_at(mesh, pos), out.block_index(pos))
            if key not in out.blocks:
                out.blocks[key] = make(key[0], out.block_slices(key[1]))
        return out

    @staticmethod
    def place(x: torch.Tensor, spec: Spec, mesh: Mesh, requires_grad: bool = False) -> "Sharded":
        """Split `x` by `spec` over `mesh`: each (device, block) its own
        contiguous copy."""
        return Sharded._filled(x.shape, spec, mesh, lambda dev, sl: (
            x[sl].detach().to(dev, copy=True).contiguous().requires_grad_(requires_grad)))

    @staticmethod
    def zeros(shape: Sequence[int], spec: Spec, mesh: Mesh, dtype=torch.float32) -> "Sharded":
        """A Sharded of zeros, each block made on its device."""
        return Sharded._filled(shape, spec, mesh, lambda dev, sl: torch.zeros(
            [s.stop - s.start for s in sl], dtype=dtype, device=dev))


def shard_tree(tree, specs, mesh: Mesh, requires_grad: bool = False):
    """Place every tensor leaf of `tree` by the spec at the same path of
    `specs` (a tree of specs, as param_shardings gives)."""
    flat = dict(tree_leaves(specs))
    return _map(tree, lambda path, leaf: Sharded.place(torch.as_tensor(leaf), flat[path], mesh,
                                                       requires_grad=requires_grad))


def unshard_tree(tree, device: DeviceSpec):
    """Every Sharded leaf of `tree` gathered whole on `device`; other leaves
    as they are."""
    return _map(tree, lambda path, leaf: leaf.full(device) if isinstance(leaf, Sharded) else leaf)
