"""Kimi-VL-A3B-Instruct in the port (models/kimi_vl) against its plain
float32 reference (models/kimi_vl/reference.py), at the tiny variant on
seeded random weights, on the CPU.

The program runs here in float32 through the same code as on the card
(the kernels' plain versions, the experts looped), so the program and the
reference differ only in the order of float32 sums: the absorbed against
the unabsorbed attention, batched against single rows, the latent cache
against one full forward. Each tolerance below is a few float32 roundings
of the compared values' size; a dropped term of the mathematics (an
expert, the correction bias, a RoPE, a cache position) moves them by
orders of magnitude more, as the cases that break the program show.
"""

import numpy as np
import pytest
import torch

from hippomm_tpu_torch.config import Config
from hippomm_tpu_torch.core.batch_process import process_video_folder
from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video
from hippomm_tpu_torch.memory.engine import HippocampalMemory
from hippomm_tpu_torch.models.clients import LocalVLMClient, StubClient, make_client
from hippomm_tpu_torch.models.kimi_vl import model as km
from hippomm_tpu_torch.models.kimi_vl import reference as ref
from hippomm_tpu_torch.models.kimi_vl.config import get_config
from hippomm_tpu_torch.models.kimi_vl.tokenizer import StandInTokenizer
from hippomm_tpu_torch.utils import timers as tracing

CFG = get_config("tiny")
HF = km.hf_config(CFG)
# float32 sums in another order, on values of size ~1 (logits) or ~0.1
# (image tokens): a few ulps of the largest term
TOL = 2e-5


@pytest.fixture(scope="module")
def params():
    # weights at 0.1 (the published init is 0.02): at these widths 0.02 leaves
    # attention near uniform, where a RoPE or a position barely shows
    return km.init_params(CFG, seed=3, std=0.1)


@pytest.fixture(scope="module")
def vlm(params):
    return km.KimiVL("tiny", params=params, dtype=torch.float32, device="cpu")


def _image(seed, h=56, w=84):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _row(vlm, seed, prompt="describe this image", h=56, w=84):
    img = _image(seed, h, w)
    pix = vlm.pixels([img])
    rows = vlm.encode_images([img])[0]
    return vlm.tok.chat_ids(prompt, [rows.shape[0]]), rows, pix


def _ref_logits(params, vlm, ids, pix):
    return ref.forward(params, HF, torch.tensor(ids), pix, vlm.tok.media_pad)


@pytest.mark.parametrize("hw", [(56, 84), (112, 112), (50, 70)])
def test_vit_rows_match_reference(params, vlm, hw):
    """MoonViT + projector: the padded grid, the interpolated position table
    (and the table as it is at pos_grid patches), 2-D RoPE, the merge."""
    imgs = [_image(s, *hw) for s in (1, 2)]
    pix = vlm.pixels(imgs)
    assert pix.shape[2] % 28 == 0 and pix.shape[3] % 28 == 0
    got = torch.stack(vlm.encode_images(imgs))
    want = ref.vision_forward(params, HF, pix)
    assert got.shape == want.shape == (2, -(-hw[0] // 28) * -(-hw[1] // 28), CFG.text.hidden)
    assert (got - want).abs().max().item() < TOL * want.abs().max().item() + 1e-7


def test_vit_rope_is_applied(params, vlm, monkeypatch):
    """The rows move by far more than TOL when the ViT's RoPE is left out."""
    pix = vlm.pixels([_image(4)])
    got = vlm.encode_images([_image(4)])[0]
    monkeypatch.setattr(ref, "_rotate_pairs", lambda x, angles: x)
    no_rope = ref.vision_forward(params, HF, pix)[0]
    assert (got - no_rope).abs().max().item() > 100 * TOL * no_rope.abs().max().item()


def _cache(vlm, rows, positions):
    t = CFG.text
    return torch.zeros((t.layers, rows, positions, t.kv_lora + t.rope_dim))


def test_prefill_logits_match_reference(params, vlm):
    ids, rows, pix = _row(vlm, 5)
    emb = vlm.embed(ids, [rows])[None]
    logits = vlm.prefill(emb, torch.tensor([len(ids)]), _cache(vlm, 1, len(ids)))
    want = _ref_logits(params, vlm, ids, pix)[-1]
    assert (logits[0] - want).abs().max().item() < TOL * want.abs().max().item()


def test_decode_through_latent_cache_matches_full_forward(params, vlm):
    """Prefill then greedy steps through the latent cache (the absorbed MLA):
    at every decoded position the program's logits equal the reference's
    teacher-forced full forward over the prompt and the program's tokens."""
    ids, rows, pix = _row(vlm, 6)
    g = vlm._step_graph(1, 512)
    logits = []
    with g.held():
        g.start([ids], [[rows]])
        first = int(g.state.tokens[0])
        for _ in range(12):
            g.step()
            logits.append(g.logits[0].clone())
    toks = [first] + g.state.out[0, 1:13].tolist()
    want = _ref_logits(params, vlm, ids + toks, pix)[len(ids):]
    got = torch.stack(logits)
    assert (got - want[:12]).abs().max().item() < TOL * want.abs().max().item()
    assert g.state.out[0, 1:13].tolist() == want[:12].argmax(-1).tolist()


def test_absorbed_and_unabsorbed_mla_agree(params, vlm):
    """One decode step (W_UK in q, W_UV after the latent sum) gives the
    prefill's (unabsorbed) logits for the same sequence one token longer;
    with the cache position off by one it does not."""
    ids, rows, pix = _row(vlm, 7)
    n = len(ids)
    cache = _cache(vlm, 1, n + 1)
    vlm.prefill(vlm.embed(ids[:-1], [rows])[None], torch.tensor([n - 1]), cache)
    step = vlm.decode_logits(torch.tensor([ids[-1]]), torch.tensor([n - 1]), cache.clone())
    want = vlm.prefill(vlm.embed(ids, [rows])[None], torch.tensor([n]), _cache(vlm, 1, n))
    assert (step - want).abs().max().item() < TOL * want.abs().max().item()
    off = vlm.decode_logits(torch.tensor([ids[-1]]), torch.tensor([n]), cache.clone())
    assert (off - want).abs().max().item() > 100 * TOL * want.abs().max().item()


@pytest.mark.parametrize("use_bias", [True, False])
def test_router_follows_reference_with_and_without_correction_bias(params, vlm, use_bias):
    """The correction bias changes which experts win; the program's router
    picks the reference's experts with the bias as given and with it zeroed."""
    h = torch.randn(64, CFG.text.hidden, generator=torch.Generator().manual_seed(0))
    m = params["layers"][1]["moe"]
    idx_b, _ = ref.route(HF, m, h, use_bias=True)
    idx_n, w_n = ref.route(HF, m, h, use_bias=False)
    assert not torch.equal(idx_b.sort(-1).values, idx_n.sort(-1).values)
    pm = dict(vlm._w["layers"][1]["moe"])
    if not use_bias:
        pm["bias"] = torch.zeros_like(pm["bias"])
    got_idx, got_w = km.route(CFG, pm, h)
    want_idx, want_w = ref.route(HF, m, h, use_bias=use_bias)
    assert torch.equal(got_idx.sort(-1).values, want_idx.sort(-1).values)
    torch.testing.assert_close(got_w.sort(-1).values, want_w.sort(-1).values, rtol=1e-6, atol=1e-6)


def test_moe_layer_matches_reference_and_every_expert_counts(params, vlm):
    """The grouped experts' weighted sum plus the shared expert equals the
    reference's layer; dropping one routed expert's output moves it."""
    h = torch.randn(40, CFG.text.hidden, generator=torch.Generator().manual_seed(1))
    lw = vlm._w["layers"][1]
    got = vlm._mlp(lw, h, None)
    want = ref._moe(ref._mm, HF, params["layers"][1]["moe"], h)
    assert (got - want).abs().max().item() < TOL * want.abs().max().item()
    dropped = dict(lw["moe"], down=lw["moe"]["down"].clone())
    idx, _ = km.route(CFG, lw["moe"], h)
    dropped["down"][int(idx[0, 0])] = 0.0
    assert (vlm._mlp({"moe": dropped}, h, None) - want).abs().max().item() > 100 * TOL * want.abs().max().item()


def test_moe_counts_only_live_rows(vlm):
    """The device-side route counts (experts hit, rows routed, the busiest
    expert's rows) take the rows `live` marks, so a bucket's padding and
    finished rows add nothing; the output is the same either way."""
    h = torch.randn(12, CFG.text.hidden, generator=torch.Generator().manual_seed(2))
    m = vlm._w["layers"][1]["moe"]
    live = torch.arange(12) < 5
    got, every = torch.zeros(3, dtype=torch.long), torch.zeros(3, dtype=torch.long)
    out = vlm._moe(m, h, got, live)
    assert torch.equal(out, vlm._moe(m, h, every))
    idx, _ = km.route(CFG, m, h[:5])
    per = torch.bincount(idx.reshape(-1), minlength=CFG.text.n_routed)
    assert got.tolist() == [int((per > 0).sum()), 5 * CFG.text.topk, int(per.max())]
    assert every[1] == 12 * CFG.text.topk


def test_batched_rows_match_each_row_alone(vlm):
    """Rows of different lengths in one bucket (padded prefill, per-row
    positions in the decode) give each row's own greedy completion."""
    rows = [_row(vlm, s, prompt=p) for s, p in ((8, "describe"), (9, "describe this image in a word"),
                                                (10, "what is in it"))]
    prompts, images = [r[0] for r in rows], [[r[1]] for r in rows]
    together = vlm.generate_ids(prompts, images, 10)
    alone = [vlm.generate_ids([p], [i], 10)[0] for p, i in zip(prompts, images)]
    assert together == alone
    assert vlm.loops[-4]["rows"] == 4 and vlm.loops[-4]["real"] == 3


def test_stand_in_tokenizer_round_trips():
    tok = StandInTokenizer(CFG.text.vocab_size, CFG.n_special)
    ids = list(range(0, tok.n_words, 7))
    assert tok.encode(tok.decode(ids)) == ids
    assert tok.encode("a frame of the scene") == tok.encode("a frame of the scene")
    assert all(0 <= i < tok.n_words for i in tok.encode("x zz zab za z ,"))
    assert tok.decode([tok.im_end, tok.media_pad]) == ""
    assert len(set(tok.special.values())) == len(tok.special)
    assert min(tok.special.values()) == tok.n_words


def test_make_client_selects_the_local_vlm(vlm, tmp_path):
    """An engine handed a VLM (models["vlm"]) wraps it in LocalVLMClient as
    its captioner and summariser; make_client keeps to the endpoints."""
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "stub"
    cfg.storage.base_dir = str(tmp_path / "store")
    mem = HippocampalMemory(cfg, models={"vlm": vlm}, device="cpu")
    assert isinstance(mem.frame_client, LocalVLMClient) and mem.qwen is mem.frame_client
    assert mem.frame_client.model is vlm
    assert isinstance(make_client(None, "stub"), StubClient)


def test_engine_captions_and_summarises_through_the_vlm(tmp_path):
    """models.vlm_variant "tiny": process_video_folder captions every key
    frame and writes every event summary through the in-process VLM, with
    no stub; a caption equals the model's own caption of that frame."""
    d = tmp_path / "videos"
    d.mkdir()
    write_synthetic_video(str(d / "a.y4m"), SynthSpec(duration=8.0, fps=2.0, width=160, height=120,
                                                      scene_changes=(4.0,), seed=3),
                          audio_path=str(d / "a.wav"))
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "tiny"
    cfg.models.vlm_variant = "tiny"
    cfg.models.compute_dtype = "float32"
    cfg.storage.base_dir = str(tmp_path / "store")
    mem = HippocampalMemory(cfg, device="cpu")
    assert isinstance(mem.frame_client, LocalVLMClient) and mem.qwen is mem.frame_client
    calls = []
    orig = mem.vlm.generate_ids
    mem.vlm.generate_ids = lambda p, i, n: calls.append((len(p), n)) or orig(p, i, n)
    tracing.RING.clear()
    stats = process_video_folder(str(d), str(tmp_path / "store"), config=cfg, memory_system=mem)
    assert stats["processed"] == 1
    ev = mem.long_term_store[-1]
    assert len(ev.frame_captions) == len(ev.frames) > 0
    assert calls == [(len(ev.frames), 128), (1, 128)]  # one batched caption call, one summary
    assert not any("synthetic" in c for c in ev.frame_captions) and "synthetic" not in ev.summary
    with open(ev.frames[0], "rb") as f:
        assert mem.frame_client.caption_images([f.read()], "Describe this image in one concise sentence.") == \
            [ev.frame_captions[0]]
    names = {r.name for r in tracing.RING}
    assert {"vlm.vision", "vlm.prefill", "vlm.decode", "vlm.tokens_prefilled", "moe.rows_routed"} <= names
