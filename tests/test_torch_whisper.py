"""The PyTorch port's Whisper against the JAX package's: the mel frontend,
the encoder and teacher-forced decoder, greedy and beam decode, the
transcriber, the checkpoint converter and the `Whisper` wrapper. Tiny
config, fp32, the same weights on both sides (JAX init carried across with
carry.params_from_jax)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models.foundation import Whisper as JWhisper
from hippomm_tpu.models.whisper import model as jwm
from hippomm_tpu.models.whisper.transcribe import WhisperTranscriber as JTranscriber
from hippomm_tpu.ops.mel import WhisperMel as JMel
from hippomm_tpu_torch.models.foundation import Whisper as TWhisper
from hippomm_tpu_torch.models.whisper import model as twm
from hippomm_tpu_torch.models.whisper.carry import params_from_jax
from hippomm_tpu_torch.models.whisper.transcribe import WhisperTranscriber as TTranscriber
from hippomm_tpu_torch.ops.mel import WhisperMel as TMel
from hippomm_tpu_torch.utils import timers
from torch_parity import assert_close

CFG = jwm.tiny_config()


class IdTokenizer:
    """Decodes ids to their decimal text, so segments carry comparable text."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def whisper_trees(seed: int = 0):
    """(JAX tree with non-trivial biases and norms, the port's params). The
    decoder's position embedding leans toward <|endoftext|>'s embedding,
    more at every position, so decodes end before max_len instead of
    repeating one token to the end."""
    tree = jwm.init_whisper(jax.random.PRNGKey(seed), CFG)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.asarray(a + 0.05 * rng.standard_normal(a.shape), np.float32), tree)
    lean = 0.6 * np.arange(CFG.max_target_positions)[:, None] * tree["decoder"]["token_embedding"][CFG.eot_token]
    tree["decoder"]["pos_embed"] = (tree["decoder"]["pos_embed"] + lean).astype(np.float32)
    return tree, params_from_jax(tree, CFG, "cpu", torch.float32)


@pytest.fixture(scope="module")
def trees():
    return whisper_trees()


#: the position whose token every row still running is forced to follow
#: with <|endoftext|> in the forced_eot case
FORCED_AT = 15


@pytest.fixture(scope="module")
def forced_trees(trees):
    """The trees with the position embedding at FORCED_AT pushed far along
    <|endoftext|>'s embedding: every row still running emits it next."""
    jtree = jax.tree.map(np.copy, trees[0])
    dec = jtree["decoder"]
    dec["pos_embed"][FORCED_AT] += 20.0 * dec["token_embedding"][CFG.eot_token]
    return jtree, params_from_jax(jtree, CFG, "cpu", torch.float32)


def _case(case, trees, enc_pair, forced_trees):
    """(JAX tree, params, JAX encoder output, the port's) of a decode case:
    `lean` as built; `forced_eot` with the forced trees and chunk 1's
    encoder output zeroed (a silent chunk), which ends that row early."""
    if case == "lean":
        return (*trees, *enc_pair)
    want_enc, got_enc = np.array(enc_pair[0]), enc_pair[1].clone()
    want_enc[1] = 0.0
    got_enc[1] = 0.0
    return (*forced_trees, want_enc, got_enc)


def _assert_forced(tokens, lengths):
    """Chunk 1 ended before FORCED_AT, every other row right after it; the
    loop exited there: rows finished earlier hold <|endoftext|> up to the
    exit and every token past it is still zero."""
    tokens = tokens.reshape(-1, tokens.shape[-1])
    lengths = lengths.reshape(-1)
    end = FORCED_AT + 1
    assert int(lengths.max()) == end and int(lengths.min()) < FORCED_AT
    for row, n in zip(tokens, lengths):
        assert (row[n : end + 1] == CFG.eot_token).all() and (row[end + 1 :] == 0).all()


@pytest.fixture(scope="module")
def enc_pair(trees):
    """Encoder outputs of both packages for 3 chunks of the same mel."""
    jtree, tparams = trees
    mel = np.random.default_rng(1).standard_normal((3, CFG.n_mels, 2 * CFG.max_source_positions))
    mel = mel.astype(np.float32)
    want = np.asarray(jwm.encoder_forward(jtree, jnp.asarray(mel), CFG, dtype=jnp.float32))
    got = twm.encoder_forward(tparams, torch.from_numpy(mel), CFG, dtype=torch.float32)
    return want, got


def _prompt(b):
    """Forced decoder ids; rows past the first differ, so the rows decode
    different tokens and stop at different steps."""
    p = np.tile([[CFG.bos_token, CFG.lang_en_token, CFG.task_transcribe_token]], (b, 1))
    p[1:, 1] = 7
    p[2:, 1:] = (100, 31)
    return p.astype(np.int32)


def test_whisper_mel_matches_jax(request):
    rng = np.random.default_rng(2)
    pcm = (0.1 * rng.standard_normal((2, 3 * 16000 + 77))).astype(np.float32)
    pcm[1, 16000:20000] = 0.0  # a silent stretch reaches the max − 8 floor
    jmel = JMel(n_mels=128)
    want = np.stack([np.asarray(jmel(jnp.asarray(p))) for p in pcm])
    got = TMel(n_mels=128, device="cpu")(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape == (2, 128, pcm.shape[1] // 160)
    assert_close(request, got, want, 1e-4)


def test_encoder_forward_matches_jax(request, enc_pair):
    want, got = enc_pair
    assert got.dtype == torch.float32 and got.shape == (3, CFG.max_source_positions, CFG.d_model)
    assert_close(request, got.numpy(), want, 1e-5)


def test_decoder_forward_matches_jax(request, trees, enc_pair):
    jtree, tparams = trees
    want_enc, got_enc = enc_pair
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, size=(3, 9)).astype(np.int32)
    want = np.asarray(jwm.decoder_forward(jtree, jnp.asarray(tokens), jnp.asarray(want_enc), CFG,
                                          dtype=jnp.float32))
    got = twm.decoder_forward(tparams, torch.from_numpy(tokens), got_enc, CFG, dtype=torch.float32)
    assert got.shape == (3, 9, CFG.vocab_size)
    assert_close(request, got.numpy(), want, 1e-5)


@pytest.mark.parametrize("case", ["lean", "forced_eot"])
def test_greedy_decode_matches_jax(trees, enc_pair, forced_trees, case):
    jtree, tparams, want_enc, got_enc = _case(case, trees, enc_pair, forced_trees)
    want_t, want_l = jwm.greedy_decode(jtree, jnp.asarray(want_enc), jnp.asarray(_prompt(3)), CFG,
                                       max_len=CFG.max_target_positions, dtype=jnp.float32)
    got_t, got_l = twm.greedy_decode(tparams, got_enc, torch.from_numpy(_prompt(3)), CFG,
                                     max_len=CFG.max_target_positions, dtype=torch.float32)
    assert got_t.shape == (3, CFG.max_target_positions) and got_l.shape == (3,)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    # the rows stop at different steps and before max_len: the early exit
    # and the finished-row EOT fill are both exercised
    assert len(set(np.asarray(want_l).tolist())) > 1 and np.asarray(want_l).max() < CFG.max_target_positions
    if case == "forced_eot":
        _assert_forced(got_t.numpy(), got_l.numpy())


def test_kept_decode_buffers_reused_on_cpu(trees, enc_pair, forced_trees):
    """A DecodeGraphs kept across decodes gives every decode what a fresh
    greedy_decode gives, over the same weights again and over others (its
    cache, models/decode.GraphCache: tests/test_torch_decode.py)."""
    _, tparams = trees
    got_enc, prompt = enc_pair[1], torch.from_numpy(_prompt(3))
    ml = CFG.max_target_positions
    graphs = twm.DecodeGraphs()
    for params in (tparams, tparams, forced_trees[1]):
        want_t, want_l = twm.greedy_decode(params, got_enc, prompt, CFG, max_len=ml, dtype=torch.float32)
        got_t, got_l = graphs.decode([(params, got_enc, prompt)], CFG, max_len=ml, dtype=torch.float32)[0]
        assert torch.equal(got_t, want_t) and torch.equal(got_l, want_l)


@pytest.mark.parametrize("beam,case", [(1, "lean"), (3, "lean"), (1, "forced_eot"), (3, "forced_eot")],
                         ids=["1", "3", "1-forced_eot", "3-forced_eot"])
def test_beam_decode_batch_matches_jax(request, trees, enc_pair, forced_trees, beam, case):
    jtree, tparams, want_enc, got_enc = _case(case, trees, enc_pair, forced_trees)
    want = jwm.beam_decode_batch(jtree, jnp.asarray(want_enc), jnp.asarray(_prompt(3)), CFG,
                                 max_len=CFG.max_target_positions, beam=beam, dtype=jnp.float32)
    got = twm.beam_decode_batch(tparams, got_enc, torch.from_numpy(_prompt(3)), CFG,
                                max_len=CFG.max_target_positions, beam=beam, dtype=torch.float32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_close(request, got[2].numpy(), np.asarray(want[2]), 1e-4, "max_abs_err_scores")
    if case == "forced_eot":
        _assert_forced(got[0].numpy(), got[1].numpy())
    # one chunk alone decodes as in the batch, up to its EOT (the batch
    # keeps filling EOT until every chunk has finished)
    tok1, len1, _ = twm.beam_decode(tparams, got_enc[:1], torch.from_numpy(_prompt(1)), CFG,
                                    max_len=CFG.max_target_positions, beam=beam, dtype=torch.float32)
    np.testing.assert_array_equal(len1.numpy(), got[1][0].numpy())
    end = int(len1.max()) + 1
    np.testing.assert_array_equal(tok1[:, :end].numpy(), got[0][0, :, :end].numpy())


@pytest.mark.parametrize("beam_size", [1, 3])
def test_transcribe_many_matches_jax(trees, beam_size):
    jtree, tparams = trees
    rng = np.random.default_rng(4)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3 * 16000, 16000, 5 * 16000)]
    out = []
    for tr in (JTranscriber(jax.tree.map(jnp.asarray, jtree), CFG, IdTokenizer(), jnp.float32,
                            beam_size=beam_size),
               TTranscriber(tparams, CFG, IdTokenizer(), torch.float32, beam_size=beam_size)):
        tr._chunk_samples = 2 * 16000  # the tiny config covers 2 s per window
        t0 = time.perf_counter_ns()
        out.append(tr.transcribe_many(clips, max_new_tokens=12))
    # the CPU steps eagerly, greedy or beam: decode steps, and no graph's
    names = {r.name for r in list(timers.RING) if r.start_ns >= t0}
    assert "asr.decode_step" in names and not names & {"asr.graph_steps", "asr.graph_captures"}
    want, got = out
    flat = [(s.start, s.end, s.text) for segs in want for s in segs]
    assert [[(s.start, s.end, s.text) for s in segs] for segs in got] == [
        [(s.start, s.end, s.text) for s in segs] for segs in want
    ]
    assert all(text for _, _, text in flat) and all(len(r) >= 1 for r in want)


def _hf_state_dict():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=CFG.vocab_size, num_mel_bins=CFG.n_mels, d_model=CFG.d_model,
        encoder_layers=CFG.encoder_layers, decoder_layers=CFG.decoder_layers,
        encoder_attention_heads=CFG.heads, decoder_attention_heads=CFG.heads,
        encoder_ffn_dim=CFG.ffn, decoder_ffn_dim=CFG.ffn,
        max_source_positions=CFG.max_source_positions,
        max_target_positions=CFG.max_target_positions, pad_token_id=0,
        bos_token_id=CFG.bos_token, eos_token_id=CFG.eot_token,
        decoder_start_token_id=CFG.bos_token,
    )
    torch.manual_seed(0)
    return transformers.WhisperModel(hf_cfg).eval().state_dict()


def test_convert_state_dict_matches_jax_converter():
    from hippomm_tpu.models.whisper.convert import convert_state_dict as jconvert
    from hippomm_tpu_torch.models.whisper.convert import checkpoint_depths, convert_state_dict

    sd = _hf_state_dict()
    want = jconvert(sd, CFG)
    got = convert_state_dict(sd, CFG)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b)
    assert checkpoint_depths(sd) == {"encoder": CFG.encoder_layers, "decoder": CFG.decoder_layers}


def test_whisper_wrapper_checkpoint_matches_jax(tmp_path):
    """A pytorch_model.bin in a directory loads through both wrappers and
    transcribes alike; a wrong variant and a path without a checkpoint raise."""
    sd = _hf_state_dict()
    torch.save({f"model.{k}": v for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    pcm = (0.1 * np.random.default_rng(5).standard_normal(3 * 16000)).astype(np.float32)
    wrappers = (
        JWhisper(model_path=str(tmp_path), variant="tiny", dtype=jnp.float32, beam_size=1),
        TWhisper(model_path=str(tmp_path), variant="tiny", dtype=torch.float32, beam_size=1,
                 device="cpu"),
    )
    out = []
    for w in wrappers:
        w._impl._chunk_samples = 2 * 16000
        w._impl.tokenizer = IdTokenizer()
        out.append([(s.start, s.end, s.text) for s in w.transcribe(pcm)])
    assert out[1] == out[0] and out[0]
    with pytest.raises(ValueError, match="layers"):
        TWhisper(model_path=str(tmp_path), variant="distil-large-v3", device="cpu")
    with pytest.raises(FileNotFoundError):
        TWhisper(model_path=str(tmp_path / "absent"), device="cpu")


def test_whisper_wrapper_random_init_and_variants():
    w = TWhisper(variant="tiny", dtype=torch.float32, device="cpu", seed=3)
    assert w.cfg == twm.tiny_config() and w._impl.params["encoder"]["blocks"][0]["mlp"]["fc1"]["weight"].dtype == torch.float32
    fin = w.transcribe_async(np.zeros(16000, np.float32))
    segs = fin()
    assert segs and all(s.end <= 1.0 and s.text == "" for s in segs)  # no tokenizer: empty text
    r = TWhisper(model_name="distil-large-v3", random_init=False, device="cpu")
    assert r.cfg is None and r.transcribe_async(np.zeros(16000, np.float32)) is None  # the stub
    with pytest.raises(NotImplementedError, match="transcription-only"):
        w()
