"""Entry points of the port: a one-device forward and a multi-device dry run.

Counterpart of the repository's `__graft_entry__.py` (`entry`,
`dryrun_multichip`) for the PyTorch port. The dry run takes an explicit
device list — it runs on ["cpu"] * n on a host without CUDA and on
[cuda:0] * n on one card — and drives every parallel path of the port on
tiny shapes: the dp×tp train step, ZeRO-1, a replica mesh, the dp×pp×tp×sp
step, the sharded ImageBind encode, the sharded store and index, the
expert-parallel MoE adapter step and the sharded beam-5 Whisper decode. It
prints JAX's line (MULTICHIP_r05.json's fields).

    python -c "from hippomm_tpu_torch.graft_entry import dryrun_multichip; \\
               dryrun_multichip(8, devices=['cpu'] * 8)"
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hippomm_tpu_torch.parallel.mesh import DeviceSpec, canonical_device


def entry(device=None):
    """(fn, example_args): the ImageBind ViT-H/14 vision tower's forward in
    bf16 on `device` (CUDA unless the caller asks for the CPU) at a
    production batch of 32."""
    from hippomm_tpu_torch.models.imagebind.model import huge_config, init_imagebind, vision_forward
    from hippomm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = huge_config()
    params = init_imagebind(cfg, dev)

    def fn(params, images):
        with torch.no_grad():
            return vision_forward(params, images, cfg, torch.bfloat16)

    images = torch.zeros((32, 3, cfg.image_size, cfg.image_size), device=dev)
    return fn, (params, images)


def _batch(rng, cfg, b: int):
    images = rng.normal(size=(b, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(b, cfg.context_length)).astype(np.int64)
    tokens[:, -1] = cfg.vocab_size - 1
    return images, tokens


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceSpec]] = None) -> Dict:
    """One train step of each parallel path over the first `n_devices` of
    `devices` (default: every CUDA device of this host), on tiny shapes, in
    fp32 on every device type, as the JAX package's dry run trains. Asserts
    every result finite, prints one line and returns its numbers."""
    from hippomm_tpu_torch.memory.schema import ThetaEvent
    from hippomm_tpu_torch.models.foundation import ImageBind
    from hippomm_tpu_torch.models.imagebind.model import tiny_config
    from hippomm_tpu_torch.models.whisper.model import get_config as wh_config
    from hippomm_tpu_torch.models.whisper.model import init_whisper
    from hippomm_tpu_torch.models.whisper.transcribe import WhisperTranscriber
    from hippomm_tpu_torch.parallel.mesh import make_mesh, unshard_tree
    from hippomm_tpu_torch.parallel.sharded_store import ShardedFeatureIndex, ShardedFeatureStore
    from hippomm_tpu_torch.train import contrastive as tc

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) got {len(devices)} devices")
    dtype = torch.float32
    out: Dict = {}
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(devices=devices, model_parallel=model_parallel)
    out["mesh"] = mesh.shape
    cfg = tiny_config()
    rng = np.random.default_rng(0)

    # dp × tp
    params, opt = tc.init_train_state(cfg, mesh=mesh, learning_rate=1e-4)
    images, tokens = _batch(rng, cfg, mesh.shape["data"] * 2)
    out["loss"] = float(tc.make_train_step(cfg, opt, dtype=dtype, mesh=mesh)(params, images, tokens)["loss"])
    assert np.isfinite(out["loss"]), f"non-finite loss: {out['loss']}"
    line = f"dryrun_multichip ok: mesh={dict(mesh.shape)}, train loss={out['loss']:.4f}"

    # ZeRO-1: the AdamW moments split over "data" as well
    if mesh.shape["data"] >= 2:
        pz, oz = tc.init_train_state(cfg, mesh=mesh, learning_rate=1e-4, zero1=True)
        out["zero1_loss"] = float(tc.make_train_step(cfg, oz, dtype=dtype, mesh=mesh)(pz, images, tokens)["loss"])
        assert np.isfinite(out["zero1_loss"])
        line += f", zero1 ok (moments sharded data={mesh.shape['data']}, loss={out['zero1_loss']:.4f})"
        del pz, oz

    # a leading "replica" axis: data parallelism across slices
    if n_devices % (2 * model_parallel) == 0 and n_devices >= 4:
        mesh_r = make_mesh(devices=devices, model_parallel=model_parallel, dcn_replicas=2)
        pr, opr = tc.init_train_state(cfg, mesh=mesh_r, learning_rate=1e-4)
        img_r, tok_r = _batch(rng, cfg, 2 * mesh_r.shape["replica"] * mesh_r.shape["data"])
        out["replica_loss"] = float(tc.make_train_step(cfg, opr, dtype=dtype, mesh=mesh_r)(pr, img_r, tok_r)["loss"])
        assert np.isfinite(out["replica_loss"])
        line += f", replica-mesh ok ({dict(mesh_r.shape)}, loss={out['replica_loss']:.4f})"
        del pr, opr

    # dp × pp × tp × sp: the GPipe pipeline with Megatron TP+SP
    if n_devices % 4 == 0:
        mesh3 = make_mesh(devices=devices, model_parallel=2, pipeline_parallel=2)
        sp, opt3 = tc.init_train_state_pp(cfg, mesh3)
        img3, tok3 = _batch(rng, cfg, mesh3.shape["data"] * 4)
        out["pp_loss"] = float(tc.make_train_step_pp(cfg, mesh3, opt3, n_micro=2, dtype=dtype)(sp, img3, tok3)["loss"])
        assert np.isfinite(out["pp_loss"]), f"non-finite pp loss: {out['pp_loss']}"
        line += f", pp train loss={out['pp_loss']:.4f}"
        del sp, opt3

    # the sharded encode (data-parallel ImageBind over the mesh)
    ib = ImageBind(variant="tiny", mesh=mesh, dtype=dtype)
    frames = rng.integers(0, 256, size=(8, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
    emb = ib.encode_vision(frames)
    assert emb.shape == (8, 1024) and np.all(np.isfinite(emb))

    # the sharded store and the product's sharded index
    feats = rng.normal(size=(mesh.shape["data"] * 16, 1024)).astype(np.float32)
    events = [ThetaEvent(video_id="dry", features={"vision": feats},
                         feature_times={"vision": list(np.arange(float(len(feats))))}, end_time=float(len(feats)))]
    hits = ShardedFeatureStore.build(events, mesh, "vision").search(feats[3], k=3)
    assert hits and hits[0][3] > 0.999, hits
    out["top1_sim"] = float(hits[0][3])
    idx = ShardedFeatureIndex.build(events, "vision", mesh)
    shits = idx.search(feats[5], top_k_per_event=5, global_top_k=3)
    assert shits and shits[0].similarity > 0.999
    bhits = idx.search_batch(feats[:4], top_k_per_event=5, global_top_k=3)
    assert len(bhits) == 4 and all(h for h in bhits)

    # ep: the expert-parallel MoE adapter over the frozen towers
    if model_parallel > 1:
        moe, mopt = tc.init_moe_adapter_state(cfg, mesh, n_experts=2 * model_parallel, seed=2)
        frozen = unshard_tree(params, devices[0])
        img_m, tok_m = _batch(rng, cfg, mesh.shape["data"] * model_parallel)
        mmet = tc.make_train_step_moe(frozen, cfg, mesh, mopt, dtype=dtype)(moe, img_m, tok_m)
        out["moe_loss"], out["moe_balance"] = float(mmet["loss"]), float(mmet["balance"])
        assert np.isfinite(out["moe_loss"]) and np.isfinite(out["moe_balance"])

    # the sharded beam-5 Whisper decode
    wcfg = wh_config("tiny")
    wparams = init_whisper(wcfg, devices[0], dtype=dtype, seed=1)
    tr = WhisperTranscriber(wparams, wcfg, None, dtype, beam_size=5, mesh=mesh)
    tr._chunk_samples = 2 * 16000
    segs = tr.transcribe_many([np.zeros(2 * 16000, np.float32)], max_new_tokens=4,
                              max_chunk_batch=mesh.shape["data"])
    assert len(segs) == 1

    line += f", retrieval top1 sim={out['top1_sim']:.4f}"
    print(line, flush=True)
    out["line"] = line
    return out
