"""The PyTorch port stands alone: importing it (in a fresh interpreter) pulls
in neither `jax` nor any module of the JAX package, and every entry point
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
]

_PROBE = """
import importlib, sys
before = set(sys.modules)
for name in {mods!r}:
    importlib.import_module(name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "hippomm_tpu" or m.startswith("hippomm_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(mods=_MODULES)],
                          capture_output=True, text=True, cwd=repo, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["engine", "imagebind", "whisper", "search_index", "keyframe_scanner",
                                   "batch_main", "qa_service", "serve_main"])
def test_entry_point_without_device_raises_without_cuda(entry, monkeypatch, tmp_path):
    import torch

    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core import batch_process, serve
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.ops.keyframe import KeyframeScanner
    from hippomm_tpu_torch.models.foundation import ImageBind, Whisper
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex

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
            "serve_main": lambda: serve.main(["--memory-store", str(tmp_path / "store"), "--port", "0"])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_whisper_stub_needs_no_device(monkeypatch):
    """The stub transcriber runs no tower, so it builds without CUDA."""
    import torch

    from hippomm_tpu_torch.models.foundation import Whisper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = Whisper(variant="stub")
    assert w.cfg is None and w.transcribe_async([0.0] * 16000) is None
