"""The port's parallel layer (serving half) against the JAX package's on the
8-device CPU mesh: make_mesh, the row-sharded feature index and store, the
data-parallel ImageBind encodes and vision stream, the sharded Whisper
decodes, the engine's mesh from system.mesh_* and the QA path's choice of
the sharded index; and the port's copies of utils/vector_ops and ops/color.

The JAX side runs on conftest's virtual CPU devices (`mesh8`, data 4 × model
2, or make_mesh over them). The port side runs on make_mesh(8,
devices=["cpu"] * 8): eight shards on one CPU. Weights are carried across
with params_from_jax; fp32, features within 1e-5, Whisper tokens equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.config import Config as JConfig
from hippomm_tpu.media.synth import SynthSpec as JSynthSpec
from hippomm_tpu.media.synth import generate as jgenerate
from hippomm_tpu.memory import engine as jengine
from hippomm_tpu.memory.schema import ThetaEvent as JThetaEvent
from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.whisper import model as jwm
from hippomm_tpu.models.whisper.transcribe import WhisperTranscriber as JTranscriber
from hippomm_tpu.ops import color as jcolor
from hippomm_tpu.parallel import mesh as jmesh
from hippomm_tpu.parallel import sharded_store as jss
from hippomm_tpu.utils import vector_ops as jvo
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.config import load_config
from hippomm_tpu_torch.media.synth import SynthSpec, generate
from hippomm_tpu_torch.memory import engine as tengine
from hippomm_tpu_torch.memory.schema import ThetaEvent
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.models.whisper import model as twm
from hippomm_tpu_torch.models.whisper.carry import params_from_jax as whisper_from_jax
from hippomm_tpu_torch.models.whisper.transcribe import WhisperTranscriber as TTranscriber
from hippomm_tpu_torch.ops import color as tcolor
from hippomm_tpu_torch.parallel import mesh as tmesh
from hippomm_tpu_torch.parallel import sharded_store as tss
from hippomm_tpu_torch.retrieval.qa import QARecallSystem
from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex
from hippomm_tpu_torch.utils import vector_ops as tvo
from torch_parity import assert_close

CPU8 = ["cpu"] * 8
WCFG = jwm.tiny_config()


def tmesh8(**kw):
    return tmesh.make_mesh(8, devices=CPU8, **kw)


# ---------------------------------------------------------------- make_mesh


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, {"model_parallel": 2}), (8, {"model_parallel": 2, "pipeline_parallel": 2}),
    (8, {"model_parallel": 2, "dcn_replicas": 2}), (8, {"dcn_replicas": 4}), (4, {"pipeline_parallel": 2}),
    (8, {"model_parallel": 3}), (6, {"model_parallel": 4}), (8, {"model_parallel": 2, "dcn_replicas": 3}),
])
def test_make_mesh_matches_jax(n, kw):
    try:
        want = jmesh.make_mesh(n, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="must divide device count"):
            tmesh.make_mesh(n, devices=CPU8, **kw)
        return
    got = tmesh.make_mesh(n, devices=CPU8, **kw)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert got.devices.size == want.devices.size == n
    assert tmesh.data_axis_size(got) == jmesh.data_axis_size(want)
    assert len(tmesh.batch_devices(got)) == tmesh.data_axis_size(got)
    assert len(tmesh.data_devices(got)) == got.shape["data"]


def test_mesh_places_shards_in_jax_order():
    """Batch shards run replica-major over the data axis at model index 0,
    as JAX's data_sharding places them; a store's rows split over "data" on
    the first replica."""
    devs = [f"cuda:{i}" for i in range(8)]
    m = tmesh.make_mesh(8, model_parallel=2, dcn_replicas=2, devices=devs)
    assert [str(d) for d in tmesh.batch_devices(m)] == ["cuda:0", "cuda:2", "cuda:4", "cuda:6"]
    assert [str(d) for d in tmesh.data_devices(m)] == ["cuda:0", "cuda:2"]
    want = jmesh.make_mesh(8, model_parallel=2, dcn_replicas=2)
    ids = [d.id for d in want.devices[:, :, 0].reshape(-1)]
    assert ids == [0, 2, 4, 6]


def test_shard_batch_and_replicate():
    m = tmesh.make_mesh(8, model_parallel=2, dcn_replicas=2, devices=CPU8)  # batch split 4
    assert tmesh.shard_batch(np.zeros((2, 3)), m) is None
    parts = tmesh.shard_batch(np.arange(8 * 3).reshape(8, 3), m)
    assert [p.tolist() for p in parts] == np.arange(24).reshape(4, 2, 3).tolist()
    w = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    reps = tmesh.replicate(w, m)
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")]["a"] is w["a"]


# ------------------------------------------------------------ sharded search


def _events(cls, feats_per_event):
    return [cls(video_id=f"v{i}", features={"vision": f},
                feature_times={"vision": [float(t) for t in range(len(f))]},
                start_time=0.0, end_time=float(len(f)))
            for i, f in enumerate(feats_per_event)]


def _both_events(feats_per_event):
    """The same store as JAX and port ThetaEvents (equal event ids)."""
    jev, tev = _events(JThetaEvent, feats_per_event), _events(ThetaEvent, feats_per_event)
    for a, b in zip(jev, tev):
        b.event_id = a.event_id
    return jev, tev


def _store(case, rng):
    """(rows per event, query): shard layouts where a sharded top-k can go wrong."""
    d = 1024
    if case == "padding":  # 91 rows over 8 shards: 12 a shard, the last 7
        return [rng.normal(size=(13, d)).astype(np.float32) for _ in range(7)], None
    if case == "k_wider_than_shard":  # 24 rows: 3 a shard
        return [rng.normal(size=(12, d)).astype(np.float32) for _ in range(2)], None
    if case == "fewer_rows_than_shards":  # 5 rows: shards 5-7 empty
        return [rng.normal(size=(5, d)).astype(np.float32)], None
    if case == "ties":
        # one-hot rows, every fifth the same: exact cosines, equal across shards
        hot = np.zeros((40, d), np.float32)
        hot[np.arange(40), np.arange(40) % 5] = 1.0
        return [hot[:17], hot[17:]], np.linspace(1.0, 0.2, d).astype(np.float32)
    if case == "negative":
        # 75 rows, 10 a shard and 5 in the last: every score negative but
        # two, the least negative rows in the last shard. JAX's layout pads
        # that shard with 5 zero rows; unmasked, they would score 0 and push
        # its real rows out of its local top-k
        q = rng.normal(size=d).astype(np.float32)
        rows = (-2.0 * q + rng.normal(size=(75, d))).astype(np.float32)
        rows[70:] = -0.2 * q + rng.normal(size=(5, d))
        rows[4] = q
        rows[11] = q + 0.3 * rng.normal(size=d)
        return [rows[:40], rows[40:]], q
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["padding", "k_wider_than_shard", "fewer_rows_than_shards", "ties",
                                  "negative"])
def test_sharded_index_matches_jax(request, case):
    rng = np.random.default_rng(3)
    feats, q0 = _store(case, rng)
    jev, tev = _both_events(feats)
    n = sum(len(f) for f in feats)
    jidx = jss.ShardedFeatureIndex.build(jev, "vision", jmesh.make_mesh(8))
    tidx = tss.ShardedFeatureIndex.build(tev, "vision", tmesh8())
    one = FeatureSearchIndex.build(tev, "vision", device="cpu")
    assert len(tidx) == len(jidx) == n
    queries = np.stack([q0 if q0 is not None else rng.normal(size=1024).astype(np.float32),
                        rng.normal(size=1024).astype(np.float32)])
    keys = lambda hits: [(h.event_id, h.index_in_event) for h in hits]  # noqa: E731
    for k in sorted({1, min(n, 7), n}):  # the device top-k itself: rows equal
        jv, ji = jidx._topk(queries[0], k)
        tv, ti = tidx._topk(queries[0], k)
        np.testing.assert_array_equal(ti, ji)
        assert_close(request, tv, jv, 1e-5, f"max_abs_err_topk_k{k}")
    for cap, top in ((3, 5), (10, 10)):
        for q in queries:
            want = jidx.search(q, top_k_per_event=cap, global_top_k=top)
            got = tidx.search(q, top_k_per_event=cap, global_top_k=top)
            assert keys(got) == keys(want) == keys(one.search(q, top_k_per_event=cap, global_top_k=top))
            assert_close(request, [h.similarity for h in got], [h.similarity for h in want], 1e-5)
        want_b = jidx.search_batch(queries, top_k_per_event=cap, global_top_k=top)
        got_b = tidx.search_batch(queries, top_k_per_event=cap, global_top_k=top)
        for w, g in zip(want_b, got_b):
            if case == "ties":  # torch.topk orders a shard's equal values as it likes
                assert_close(request, [h.similarity for h in g], [h.similarity for h in w], 1e-5)
            else:
                assert keys(g) == keys(w)
    if case == "negative":
        hits = tidx.search(queries[0], top_k_per_event=75, global_top_k=7)
        assert [h.similarity > 0 for h in hits] == [True] * 2 + [False] * 5
        assert sorted(h.index_in_event for h in hits[2:]) == [30, 31, 32, 33, 34]


def test_sharded_index_reads_once_a_round(monkeypatch):
    """A search round reads the host once, whatever the shard count, and K5
    runs once per non-empty shard."""
    from hippomm_tpu_torch.ops import topk as ttk

    rng = np.random.default_rng(5)
    _, tev = _both_events([rng.normal(size=(9, 1024)).astype(np.float32) for _ in range(3)])
    idx = tss.ShardedFeatureIndex.build(tev, "vision", tmesh8())  # 27 rows: 4 a shard, 7 shards
    reads = []
    real_read = tss.read_packed
    monkeypatch.setattr(tss, "read_packed", lambda both: reads.append(1) or real_read(both))
    before = ttk.top_k_cosine_kernel.launches
    idx._topk(rng.normal(size=1024).astype(np.float32), 20)
    assert len(reads) == 1 and len(idx._shards.parts) == 7
    assert ttk.top_k_cosine_kernel.launches == before  # plain version on the CPU: no launch


@pytest.mark.parametrize("rows,k", [((20, 50), 7), ((3, 7), 3), ((1, 5), 5)])
def test_sharded_store_search_matches_jax(request, rows, k):
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(rows[1], 1024)).astype(np.float32) for _ in range(rows[0])]
    jev, tev = _both_events(feats)
    jstore = jss.ShardedFeatureStore.build(jev, jmesh.make_mesh(8), "vision")
    tstore = tss.ShardedFeatureStore.build(tev, tmesh8(), "vision")
    assert len(tstore) == len(jstore) == rows[0] * rows[1]
    for q in (rng.normal(size=1024).astype(np.float32), feats[-1][2]):
        want, got = jstore.search(q, k=k), tstore.search(q, k=k)
        assert [h[:3] for h in got] == [h[:3] for h in want] and len(got) == k
        assert_close(request, [h[3] for h in got], [h[3] for h in want], 1e-5)
    assert tss.ShardedFeatureStore.build([], tmesh8()).search(feats[0][0]) == []


# ------------------------------------------------------------ sharded towers


@pytest.fixture(scope="module")
def towers(mesh8):
    """The tiny ImageBind in fp32 on the JAX mesh, and the port's on an
    8-shard mesh and on one device, all with the JAX weights."""
    jib = JImageBind(variant="tiny", seed=3, mesh=mesh8, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu", torch.float32)
    tib = TImageBind(variant="tiny", dtype=torch.float32, params=params, mesh=tmesh8())
    one = TImageBind(variant="tiny", dtype=torch.float32, params=params, device="cpu")
    return jib, tib, one


def test_sharded_encodes_match_jax(request, towers):
    jib, tib, one = towers
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(16, 56, 56, 3)).astype(np.uint8)
    texts = ["a red square", "a blue circle", "tone", "speech", "cat", "dog", "sea", "sky"]
    got_v = tib.encode_vision(frames)
    assert_close(request, got_v, jib.encode_vision(frames), 1e-5, "max_abs_err_vision")
    assert_close(request, got_v, one.encode_vision(frames), 1e-5, "max_abs_err_vision_one_device")
    got_t = tib.encode_text(texts)
    assert_close(request, got_t, jib.encode_text(texts), 1e-5, "max_abs_err_text")
    assert_close(request, got_t, one.encode_text(texts), 1e-5, "max_abs_err_text_one_device")
    dev = tib.encode_text_device(texts)
    assert dev.device == torch.device("cpu") and dev.shape == (8, 1024)


def test_sharded_encode_runs_one_slab_per_shard(towers, monkeypatch):
    """A 32-frame chunk runs as 8 slabs of 4; 3 texts do not divide and run
    whole on the first device."""
    from hippomm_tpu_torch.models.imagebind import model as ib_model

    _, tib, _ = towers
    seen = []
    for name in ("vision_forward", "text_forward"):
        real = getattr(ib_model, name)
        monkeypatch.setattr(ib_model, name, lambda p, x, *a, real=real, name=name:
                            seen.append((name, x.shape[0])) or real(p, x, *a))
    tib.encode_vision(np.zeros((3, 40, 40, 3), np.uint8))
    tib.encode_text(["a", "b", "c"])
    assert seen == [("vision_forward", 4)] * 8 + [("text_forward", 3)]


def test_vision_stream_on_mesh_matches_encode(request, towers):
    _, tib, _ = towers
    rng = np.random.default_rng(1)
    s = tib.cfg.image_size
    frames = rng.integers(0, 256, size=(40, s * 2, s * 3, 3)).astype(np.uint8)
    stream = tib.vision_stream()
    for lo, hi in ((0, 7), (7, 25), (25, 40)):
        stream.feed(frames[lo:hi])
    got = stream.result()
    assert got.shape == (40, 1024)
    assert_close(request, got, tib.encode_vision(frames), 1e-5)


def test_replica_mesh_indivisible_batches_run_whole(request, towers):
    """data × replica = 4: 2 texts divide the data axis (2) but not the
    batch split, so they run whole on the first device; JAX runs them
    replicated. Whisper's chunk batch takes the same gate."""
    jib, _, one = towers
    m = tmesh.make_mesh(8, model_parallel=2, dcn_replicas=2, devices=CPU8)
    jm = jmesh.make_mesh(8, model_parallel=2, dcn_replicas=2)
    tib = TImageBind(variant="tiny", dtype=torch.float32, params=one.params, mesh=m)
    jrep = JImageBind(variant="tiny", seed=3, mesh=jm, dtype=jnp.float32)
    texts = ["a red square", "a blue circle"]
    assert_close(request, tib.encode_text(texts), jrep.encode_text(texts), 1e-5)
    jtree, tparams = _whisper_trees()
    segs = []
    for tr in (JTranscriber(jax.tree.map(jnp.asarray, jtree), WCFG, _IdTokenizer(), jnp.float32,
                            beam_size=1, mesh=jm),
               TTranscriber(tparams, WCFG, _IdTokenizer(), torch.float32, beam_size=1, mesh=m)):
        tr._chunk_samples = 2 * 16000
        segs.append(tr.transcribe_many([np.zeros(4 * 16000, np.float32)], max_new_tokens=4,
                                       max_chunk_batch=2))
    assert [(s.start, s.end, s.text) for s in segs[1][0]] == [(s.start, s.end, s.text) for s in segs[0][0]]


# ------------------------------------------------------------ sharded Whisper


class _IdTokenizer:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


@functools.lru_cache(maxsize=1)
def _whisper_trees():
    """Tiny Whisper with non-trivial weights whose decodes end before
    max_len (the position embedding leans toward <|endoftext|>)."""
    tree = jwm.init_whisper(jax.random.PRNGKey(0), WCFG)
    rng = np.random.default_rng(100)
    tree = jax.tree.map(lambda a: np.asarray(a + 0.05 * rng.standard_normal(a.shape), np.float32), tree)
    lean = 0.6 * np.arange(WCFG.max_target_positions)[:, None] * tree["decoder"]["token_embedding"][WCFG.eot_token]
    tree["decoder"]["pos_embed"] = (tree["decoder"]["pos_embed"] + lean).astype(np.float32)
    return tree, whisper_from_jax(tree, WCFG, "cpu", torch.float32)


@pytest.mark.parametrize("beam_size", [1, 2])
def test_sharded_transcribe_matches_jax(mesh8, beam_size):
    """9 s in 2 s windows: 5 chunks in a batch of 8 (16 with beam), split 4
    ways on the JAX mesh and 8 ways on the port's; the segments (text = the
    token ids) equal JAX's and the port's one-device transcriber's."""
    jtree, tparams = _whisper_trees()
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.normal(size=9 * 16000)).astype(np.float32)]
    out = []
    for tr in (JTranscriber(jax.tree.map(jnp.asarray, jtree), WCFG, _IdTokenizer(), jnp.float32,
                            beam_size=beam_size, mesh=mesh8),
               TTranscriber(tparams, WCFG, _IdTokenizer(), torch.float32, beam_size=beam_size,
                            mesh=tmesh8()),
               TTranscriber(tparams, WCFG, _IdTokenizer(), torch.float32, beam_size=beam_size)):
        tr._chunk_samples = 2 * 16000
        out.append([[(s.start, s.end, s.text) for s in segs]
                    for segs in tr.transcribe_many(clips, max_new_tokens=6, max_chunk_batch=8)])
    assert out[1] == out[0] == out[2]
    assert all(text for _, _, text in out[0][0])


@pytest.mark.parametrize("beam", [1, 3])
def test_lockstep_decode_equals_each_shards_own_decode(beam):
    """Shards stepped in lockstep give each shard's own decode up to its
    rows' <|endoftext|>, and the lengths; the loop runs until the slowest
    shard's rows finish (a finished shard keeps emitting <|endoftext|>)."""
    _, tparams = _whisper_trees()
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((4, WCFG.n_mels, 2 * WCFG.max_source_positions))
                           .astype(np.float32))
    enc = twm.encoder_forward(tparams, mel, WCFG, dtype=torch.float32)
    prompt = torch.tensor([[WCFG.bos_token, WCFG.lang_en_token, WCFG.task_transcribe_token]] * 2)
    shards = [(tparams, enc[:2], prompt), (tparams, enc[2:], prompt)]
    ml = WCFG.max_target_positions
    if beam == 1:
        both = twm.greedy_decode_shards(shards, WCFG, max_len=ml, dtype=torch.float32)
        alone = [twm.greedy_decode(*s, WCFG, max_len=ml, dtype=torch.float32) for s in shards]
        whole = twm.greedy_decode(tparams, enc, torch.cat([prompt, prompt]), WCFG, max_len=ml,
                                  dtype=torch.float32)
        np.testing.assert_array_equal(torch.cat([t for t, _ in both]).numpy(), whole[0].numpy())
    else:
        both = twm.beam_decode_shards(shards, WCFG, max_len=ml, beam=beam, dtype=torch.float32)
        alone = [twm.beam_decode_batch(*s, WCFG, max_len=ml, beam=beam, dtype=torch.float32)
                 for s in shards]
    for got, want in zip(both, alone):
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        for row_t, row_w, ln in zip(got[0].reshape(-1, ml), want[0].reshape(-1, ml), got[1].reshape(-1)):
            end = min(int(ln) + 1, ml)
            np.testing.assert_array_equal(row_t[:end].numpy(), row_w[:end].numpy())
    lengths = torch.cat([ln.reshape(-1) for _, ln, *_ in both])
    assert len(set(lengths.tolist())) > 1 and int(lengths.max()) < ml


# ------------------------------------------------------------ engine and QA


def _cfg(cls, base_dir, replicas=1, model=1):
    cfg = cls()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "stub"
    cfg.models.compute_dtype = "float32"
    cfg.system.mesh_replicas = replicas
    cfg.system.mesh_model = model
    cfg.storage.base_dir = str(base_dir)
    return cfg


_CLIP = dict(duration=24.0, fps=2.0, width=160, height=120, seed=6)


def _ingest(mem, res):
    mem.add_video("vid", "")
    mem.process_sequence("vid", frame_paths=[f"f_{i}.jpg" for i in range(len(res.frames))],
                         frame_times=res.frame_times, frames_rgb=res.frames, audio_data=res.audio)
    assert len(mem.long_term_store) == 1
    return mem.long_term_store[0]


@pytest.mark.parametrize("replicas,model,shape", [
    (1, 1, {"data": 8, "model": 1}), (2, 2, {"replica": 2, "data": 2, "model": 2})])
def test_engine_mesh_matches_jax(request, tmp_path, monkeypatch, replicas, model, shape):
    """The engine's mesh from system.mesh_* over all local devices (JAX
    engine.py:97-126) and an ingest through it: the ThetaEvent equals the
    JAX engine's on its mesh, and the QA index over it is the sharded one."""
    made = []
    monkeypatch.setattr(jengine, "ImageBind", lambda **kw: made.append(
        JImageBind(dtype=jnp.float32, **kw)) or made[-1])
    jmem = jengine.HippocampalMemory(config=_cfg(JConfig, tmp_path / "jax", replicas, model))
    assert dict(jmem.mesh.shape) == shape
    carried = params_from_jax(jax.tree.map(np.asarray, made[0].params), made[0].cfg, "cpu", torch.float32)
    monkeypatch.setattr(tengine, "ImageBind", functools.partial(TImageBind, params=carried))
    tcfg = _cfg(TConfig, tmp_path / "torch", replicas, model)
    tmem = tengine.HippocampalMemory(config=tcfg, devices=CPU8)
    assert tmem.mesh.shape == shape and tmem.imagebind.mesh is tmem.mesh
    res, jres = generate(SynthSpec(**_CLIP)), jgenerate(JSynthSpec(**_CLIP))
    np.testing.assert_array_equal(res.frames, jres.frames)
    je, te = _ingest(jmem, jres), _ingest(tmem, res)
    assert te.frames == je.frames and te.feature_times == je.feature_times
    for k, norm in (("vision", 1.0), ("audio", 20.0)):
        assert_close(request, te.features[k], je.features[k], 1e-5, f"max_abs_err_{k}", scale=norm)
    idx = QARecallSystem(tmem, tcfg)._index("vision")
    assert isinstance(idx, tss.ShardedFeatureIndex)
    hits = idx.search(te.features["vision"][0], top_k_per_event=3, global_top_k=3)
    assert hits and hits[0].similarity > 0.999


def test_engine_mesh_config_warns_or_raises(tmp_path, monkeypatch, caplog):
    """More devices than exist: a warning and one device, as in JAX. One
    device: no mesh. A mesh that fails to build raises (the JAX engine logs
    and runs on one device)."""
    cfg = _cfg(TConfig, tmp_path)
    assert tengine.HippocampalMemory(config=cfg, device="cpu").mesh is None
    for data, model in ((16, 1), (None, 16)):
        cfg.system.mesh_data, cfg.system.mesh_model = data, model
        caplog.clear()
        with caplog.at_level("WARNING"):
            mem = tengine.HippocampalMemory(config=cfg, devices=CPU8)
        assert mem.mesh is None and "needs" in caplog.text and "only 8 are available" in caplog.text
    cfg.system.mesh_data, cfg.system.mesh_model = 2, 2
    assert tengine.HippocampalMemory(config=cfg, devices=CPU8).mesh.shape == {"data": 2, "model": 2}

    def broken(*a, **k):
        raise RuntimeError("mesh build failed")

    monkeypatch.setattr(tmesh, "make_mesh", broken)
    with pytest.raises(RuntimeError, match="mesh build failed"):
        tengine.HippocampalMemory(config=cfg, devices=CPU8)


def test_a_named_device_pins_the_engine(tmp_path, monkeypatch):
    """On a host with two cards, a caller who names device="cuda:1" gets that
    card alone (no mesh); naming no device spans both, as jax.devices()."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.local_devices(None, "cuda:1") == [torch.device("cuda", 1)]
    assert tmesh.local_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tmesh.local_devices(["cpu", "cpu"], "cuda:1") == [torch.device("cpu")] * 2
    seen = []
    real = tmesh.local_devices
    monkeypatch.setattr(tmesh, "local_devices", lambda devices=None, device=None: seen.append(
        (devices, device)) or real(devices, device))
    mem = tengine.HippocampalMemory(config=_cfg(TConfig, tmp_path), device="cpu")
    assert seen == [(None, "cpu")] and mem.mesh is None and mem.device == torch.device("cpu")


def test_yaml_mesh_keys_build_the_mesh_of_every_entry_point(tmp_path, monkeypatch):
    """system.device / mesh_* load from a YAML with the JAX defaults, and
    core/serve and core/batch_process, which build their engine from the
    config, get the mesh on a host with 8 local devices."""
    from hippomm_tpu_torch.core import batch_process, serve

    jdef, tdef = JConfig().system, TConfig().system
    for key in ("device", "mesh_data", "mesh_model", "mesh_replicas", "profile_dir"):
        assert getattr(tdef, key) == getattr(jdef, key)
    assert load_config().system.mesh_model == 1  # config/default_config.yaml
    path = tmp_path / "mesh.yaml"
    path.write_text("system: {device: cpu, mesh_data: 4, mesh_model: 2}\n"
                    "api: {mode: stub}\nmodels: {imagebind_variant: tiny, whisper_variant: stub, "
                    "compute_dtype: float32}\n")
    cfg = load_config(str(path))
    assert (cfg.system.device, cfg.system.mesh_data, cfg.system.mesh_model, cfg.system.mesh_replicas) == (
        "cpu", 4, 2, 1)
    monkeypatch.setattr(tmesh, "local_devices", lambda devices=None, device=None: [torch.device("cpu")] * 8)
    cfg.storage.base_dir = str(tmp_path / "store")
    assert serve.QAService(cfg, device="cpu").memory.mesh.shape == {"data": 4, "model": 2}
    built = []
    real = tengine.HippocampalMemory
    monkeypatch.setattr(tengine, "HippocampalMemory", lambda **kw: built.append(real(**kw)) or built[-1])
    (tmp_path / "empty").mkdir()
    batch_process.process_video_folder(str(tmp_path / "empty"), str(tmp_path / "store2"), cfg, device="cpu")
    assert built and built[0].mesh.shape == {"data": 4, "model": 2}


def test_ask_question_searches_the_sharded_index(tmp_path, monkeypatch):
    """core/ask_question on an 8-device host: the question's engine has a
    mesh, its VIDEO search runs on the sharded index, and the hits equal
    the same question's on one device."""
    from hippomm_tpu_torch.core.ask_question import ask_question

    cfg = _cfg(TConfig, tmp_path)
    cfg.processing.fast_path_confidence = 2.0  # detailed recall
    _ingest(tengine.HippocampalMemory(config=cfg, device="cpu"), generate(SynthSpec(**_CLIP)))
    q = "What color is the moving square?"
    one = ask_question(q, cfg, device="cpu")
    rounds = []
    real = tss.ShardedFeatureIndex._topk_device
    monkeypatch.setattr(tss.ShardedFeatureIndex, "_topk_device",
                        lambda self, q, k: rounds.append(k) or real(self, q, k))
    monkeypatch.setattr(tmesh, "local_devices", lambda devices=None, device=None: [torch.device("cpu")] * 8)
    got = ask_question(q, cfg, device="cpu")
    assert rounds and got.question_type == one.question_type == "VIDEO"
    assert got.retrieved_segments == one.retrieved_segments and got.answer == one.answer


# ------------------------------------------------------ vector_ops and color


def test_vector_ops_match_jax(request):
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    assert_close(request, tvo.cosine_similarity(a, b, device="cpu"), jvo.cosine_similarity(a, b), 1e-6, "cosine")
    assert tvo.cosine_similarity(torch.from_numpy(a), b) == pytest.approx(jvo.cosine_similarity(a, b), abs=1e-6)
    feats = rng.normal(size=(50, 64)).astype(np.float32)
    feats[30] = feats[7]  # a tie: the lower index first, as lax.top_k
    for k in (1, 5, 50, 80):
        ti, tv = tvo.top_k_cosine_similarity(feats[7] + 0.1 * a, feats, k, device="cpu")
        ji, jv = jvo.top_k_cosine_similarity(feats[7] + 0.1 * a, feats, k)
        np.testing.assert_array_equal(ti, ji)
        assert_close(request, tv, jv, 1e-5, f"top_k_{k}")
    assert list(tvo.top_k_cosine_similarity(a, feats, 2, device="cpu")[0]) == list(jvo.top_k_cosine_similarity(a, feats, 2)[0])
    empty = np.zeros((0, 64), np.float32)
    assert [x.shape for x in tvo.top_k_cosine_similarity(a, empty, device="cpu")] == [
        x.shape for x in jvo.top_k_cosine_similarity(a, empty)] == [(0,), (0,)]
    for name, args in (("compute_entropy", (a,)), ("temporal_overlap", ((0, 4), (3, 9), 0.2)),
                       ("temporal_overlap", ((0, 4), (3, 9))), ("spatial_distance", ((1, 2), (7, 9))),
                       ("merge_features", ([a, b], [0.3, 2.0])),
                       ("gaussian_temporal_weighting", (np.arange(5.0), 2.0, 1.5)),
                       ("compute_feature_statistics", (a,)), ("normalize_features", (a, "l1")),
                       ("normalize_features", (a, "max"))):
        np.testing.assert_allclose(np.asarray(getattr(tvo, name)(*args), np.float64),
                                   np.asarray(getattr(jvo, name)(*args), np.float64), rtol=1e-5, atol=1e-6)
    for thr in (0.7, -1.0):
        assert tvo.feature_flow(a, b, thr, device="cpu") == jvo.feature_flow(a, b, thr)
    with pytest.raises(ValueError):
        tvo.normalize_features(a, "l3")


def test_vector_ops_put_numpy_input_on_cuda_by_default():
    """Numpy input runs on CUDA unless the caller names a device, as the JAX
    functions run on the default accelerator; a tensor keeps its device."""
    rng = np.random.default_rng(10)
    a, feats = rng.normal(size=16).astype(np.float32), rng.normal(size=(6, 16)).astype(np.float32)
    idx, _ = tvo.top_k_cosine_similarity(a, torch.from_numpy(feats), 3)  # the features' device
    np.testing.assert_array_equal(idx, jvo.top_k_cosine_similarity(a, feats, 3)[0])
    assert tvo.cosine_similarity(torch.from_numpy(a), feats[0]) == pytest.approx(
        jvo.cosine_similarity(a, feats[0]), abs=1e-6)
    for call in (lambda: tvo.cosine_similarity(a, feats[0]), lambda: tvo.top_k_cosine_similarity(a, feats, 3),
                 lambda: tvo.feature_flow(a, feats[0])):
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_color_matches_jax():
    """uint8 outputs equal to JAX's except where the fp32 value before
    rounding lies within 1e-3 of a .5 boundary (XLA may fuse the products
    into FMAs and round the last bit otherwise)."""
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, size=(3, 16, 24, 3)).astype(np.uint8)
    ty, tu, tv = tcolor.rgb_to_yuv420(torch.from_numpy(rgb))
    jy, ju, jv = (np.asarray(x) for x in jcolor.rgb_to_yuv420(jnp.asarray(rgb)))
    f = rgb.astype(np.float64)
    exact = {"y": 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]}
    for name, got, want in (("y", ty, jy), ("u", tu, ju), ("v", tv, jv)):
        assert got.dtype == torch.uint8 and got.shape == want.shape
        diff = got.numpy().astype(int) - want.astype(int)
        assert np.abs(diff).max() <= 1
        if name in exact:
            near = np.abs(exact[name] % 1.0 - 0.5) < 1e-3
            assert not diff[~near].any()
    back = tcolor.yuv420_to_rgb(ty, tu, tv)
    want = np.asarray(jcolor.yuv420_to_rgb(jnp.asarray(ty.numpy()), jnp.asarray(tu.numpy()),
                                           jnp.asarray(tv.numpy())))
    assert back.dtype == torch.uint8 and back.shape == rgb.shape
    assert np.abs(back.numpy().astype(int) - want.astype(int)).max() <= 1
    assert (back.numpy() != want).mean() < 1e-3
