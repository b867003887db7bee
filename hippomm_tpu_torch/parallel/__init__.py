"""The parallel layer: device meshes, sharding rules and sharded tensors
(mesh.py), the row-sharded feature store of the serving path
(sharded_store.py), the collectives over a mesh axis (collectives.py), the
towers' tensor parallelism (tensor_parallel.py), Megatron TP+SP and the
GPipe pipeline (megatron.py), and the expert-parallel Switch MoE (moe.py).
The names below are the JAX package's `hippomm_tpu.parallel` exports."""

from hippomm_tpu_torch.parallel.mesh import make_mesh, param_shardings  # noqa: F401
from hippomm_tpu_torch.parallel.sharded_store import ShardedFeatureStore  # noqa: F401
