"""Device resolution and reads (device.py), stage timers (timers.py),
token counting (tokens.py) and the feature helpers (vector_ops.py). The
names below are the JAX package's `hippomm_tpu.utils` exports."""

from hippomm_tpu_torch.utils.timers import StageTimer, Throughput  # noqa: F401
