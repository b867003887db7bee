"""Device meshes for data-parallel serving.

Counterpart of the serving half of hippomm_tpu/parallel/mesh.py. JAX drives
every local chip from one process through one `Mesh`; here one process
drives a grid of torch devices the same way:

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
`param_shardings` and the `zero1_*` rules belong to training and are not
here. No `torch.distributed` is needed: one process reaches every device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

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
