"""Dual-pathway retrieval: feature search, token budgets, QA. The name
below is the JAX package's `hippomm_tpu.retrieval` export."""

from hippomm_tpu_torch.retrieval.qa import QARecallSystem  # noqa: F401
