"""The PyTorch port stands alone: importing it (in a fresh interpreter) pulls
in neither `jax` nor any module of the JAX package (nor `transformers`, which
the token counter imports on first use), and every entry point
refuses to run silently on the CPU when CUDA is absent."""

import os
import subprocess
import sys

import pytest

_MODULES = [
    "hippomm_tpu_torch",
    "hippomm_tpu_torch.config",
    "hippomm_tpu_torch.memory.engine",
    "hippomm_tpu_torch.memory.segmentation",
    "hippomm_tpu_torch.memory.consolidation",
    "hippomm_tpu_torch.memory.store",
    "hippomm_tpu_torch.models.foundation",
    "hippomm_tpu_torch.models.layers",
    "hippomm_tpu_torch.models.imagebind.model",
    "hippomm_tpu_torch.models.imagebind.carry",
    "hippomm_tpu_torch.models.imagebind.preprocess",
    "hippomm_tpu_torch.models.imagebind.manifest",
    "hippomm_tpu_torch.models.imagebind.convert",
    "hippomm_tpu_torch.models.ckpt_io",
    "hippomm_tpu_torch.models.whisper.model",
    "hippomm_tpu_torch.models.whisper.carry",
    "hippomm_tpu_torch.models.whisper.convert",
    "hippomm_tpu_torch.models.whisper.transcribe",
    "hippomm_tpu_torch.ops.flash_attention",
    "hippomm_tpu_torch.ops.fused_mlp",
    "hippomm_tpu_torch.ops.resize",
    "hippomm_tpu_torch.ops.ssim",
    "hippomm_tpu_torch.ops.silence",
    "hippomm_tpu_torch.ops.mel",
    "hippomm_tpu_torch.ops.similarity",
    "hippomm_tpu_torch.ops.topk",
    "hippomm_tpu_torch.ops.keyframe",
    "hippomm_tpu_torch.ops._native",
    "hippomm_tpu_torch.ops.matmul",
    "hippomm_tpu_torch.train",
    "hippomm_tpu_torch.train.contrastive",
    "hippomm_tpu_torch.train.checkpoint",
    "hippomm_tpu_torch.media.synth",
    "hippomm_tpu_torch.media.io",
    "hippomm_tpu_torch.retrieval.budget",
    "hippomm_tpu_torch.retrieval.search",
    "hippomm_tpu_torch.retrieval.qa",
    "hippomm_tpu_torch.core.ask_question",
    "hippomm_tpu_torch.core.batch_process",
    "hippomm_tpu_torch.core.serve",
    "hippomm_tpu_torch.utils.timers",
    "hippomm_tpu_torch.utils.tokens",
    "hippomm_tpu_torch.utils.device",
    "hippomm_tpu_torch.utils.vector_ops",
    "hippomm_tpu_torch.ops.color",
    "hippomm_tpu_torch.parallel",
    "hippomm_tpu_torch.parallel.mesh",
    "hippomm_tpu_torch.parallel.sharded_store",
    "hippomm_tpu_torch.parallel.collectives",
    "hippomm_tpu_torch.parallel.tensor_parallel",
    "hippomm_tpu_torch.parallel.megatron",
    "hippomm_tpu_torch.parallel.moe",
    "hippomm_tpu_torch.graft_entry",
    "hippomm_tpu_torch.ops",
    "hippomm_tpu_torch.media",
    "hippomm_tpu_torch.benchmarks",
    "hippomm_tpu_torch.benchmarks.qa_harness",
    "hippomm_tpu_torch.benchmarks.qa_accuracy",
    "hippomm_tpu_torch.models.imagebind",
    "hippomm_tpu_torch.models.whisper",
    "hippomm_tpu_torch.memory",
    "hippomm_tpu_torch.retrieval",
    "hippomm_tpu_torch.utils",
]

_PROBE = """
import importlib, sys
before = set(sys.modules)
for name in {mods!r}:
    importlib.import_module(name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "hippomm_tpu" or m.startswith("hippomm_tpu.")
             or m == "transformers" or m.startswith("transformers."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(mods=_MODULES)],
                          capture_output=True, text=True, cwd=repo, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["engine", "imagebind", "whisper", "search_index", "keyframe_scanner",
                                   "batch_main", "qa_service", "serve_main", "train_state",
                                   "load_params", "run_harness"])
def test_entry_point_without_device_raises_without_cuda(entry, monkeypatch, tmp_path):
    import torch

    from hippomm_tpu_torch.benchmarks.qa_harness import run_harness
    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core import batch_process, serve
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.ops.keyframe import KeyframeScanner
    from hippomm_tpu_torch.models.foundation import ImageBind, Whisper
    from hippomm_tpu_torch.models.imagebind import model as ib_model
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex
    from hippomm_tpu_torch.train import checkpoint, init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.storage.base_dir = str(tmp_path)
    make = {"engine": lambda: HippocampalMemory(cfg), "imagebind": lambda: ImageBind(variant="tiny"),
            "whisper": lambda: Whisper(variant="tiny"),
            "search_index": lambda: FeatureSearchIndex.build([], "vision"),
            "keyframe_scanner": lambda: KeyframeScanner(90, 160),
            "batch_main": lambda: batch_process.main(["--path", str(tmp_path / "none"),
                                                      "--memory_store", str(tmp_path / "store")]),
            "qa_service": lambda: serve.QAService(cfg),
            "serve_main": lambda: serve.main(["--memory-store", str(tmp_path / "store"), "--port", "0"]),
            "train_state": lambda: init_train_state(ib_model.tiny_config()),
            "load_params": lambda: checkpoint.load_params(str(tmp_path / "params.pt")),
            "run_harness": lambda: run_harness(str(tmp_path / "qa"))}[entry]
    if entry == "load_params":
        checkpoint.save_params(str(tmp_path / "params.pt"), {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    if entry == "run_harness":  # it raises before it writes any media
        assert not (tmp_path / "qa").exists()


def test_whisper_stub_needs_no_device(monkeypatch):
    """The stub transcriber runs no tower, so it builds without CUDA."""
    import torch

    from hippomm_tpu_torch.models.foundation import Whisper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = Whisper(variant="stub")
    assert w.cfg is None and w.transcribe_async([0.0] * 16000) is None
