"""models/decode.GraphCache, the cache of captured decode steps that Whisper's
greedy decode and Kimi-VL's generation share, on the CPU at the tiny
variants with random weights: each model's decodes reuse one entry, step
it eagerly (no graph captured or counted), and rebuild it once the weights
it was built over are others; captures count under the model's own name."""

import time

import pytest
import torch

from hippomm_tpu_torch.models.kimi_vl import model as km
from hippomm_tpu_torch.models.whisper import model as twm
from hippomm_tpu_torch.utils import timers


def _whisper():
    """The transcriber's DecodeGraphs over two seeds' decoders: (cache, a
    decode over weights 0 or 1, the counters' prefix)."""
    cfg = twm.tiny_config()
    params = [twm.init_whisper(cfg, "cpu", torch.float32, seed=s) for s in (0, 1)]
    enc = torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=torch.Generator().manual_seed(2))
    prompt = torch.tensor([[cfg.bos_token, cfg.lang_en_token, cfg.task_transcribe_token]] * 3)
    graphs = twm.DecodeGraphs()

    def decode(i):
        graphs.decode([(params[i], enc, prompt)], cfg, max_len=cfg.max_target_positions, dtype=torch.float32)

    return graphs._graphs, decode, "asr"


def _kimi_vl():
    """A tiny KimiVL whose compute weights are swapped for another seed's:
    (cache, a generate over weights 0 or 1, the counters' prefix)."""
    cfg = km.get_config("tiny")
    vlm = km.KimiVL("tiny", params=km.init_params(cfg, seed=3, std=0.1), dtype=torch.float32, device="cpu")
    weights = [vlm._w, vlm._prepare(km.init_params(cfg, seed=4, std=0.1))]

    def decode(i):
        vlm._w = weights[i]
        vlm.generate_ids([list(range(5, 20)), list(range(7, 12))], [[], []], 6)

    return vlm._graphs, decode, "vlm"


@pytest.mark.parametrize("model", [_whisper, _kimi_vl], ids=["whisper", "kimi_vl"])
def test_step_graphs_reuse_an_entry_and_rebuild_it_for_other_weights_on_cpu(model):
    graphs, decode, prefix = model()
    t0 = time.perf_counter_ns()
    decode(0)
    (first,) = graphs.values()
    decode(0)
    assert list(graphs.values()) == [first] and first.graph is None
    decode(1)
    (rebuilt,) = graphs.values()
    assert rebuilt is not first and rebuilt.weights != first.weights and rebuilt.graph is None
    assert graphs.counter == rebuilt.counter == f"{prefix}.graph_captures"
    names = {r.name for r in list(timers.RING) if r.start_ns >= t0}
    assert f"{prefix}.decode_step" in names
    assert not names & {f"{prefix}.graph_steps", f"{prefix}.graph_captures"}
