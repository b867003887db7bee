"""Checkpoint loading shared by the ImageBind and Whisper converters.

Counterpart of hippomm_tpu/models/ckpt_io.py. Two on-disk formats:

  * torch pickles (`.pth`, `pytorch_model.bin`) through
    torch.load(weights_only=True), memory-mapped when the file is in torch's
    zip format, a `"state_dict"` key unwrapped;
  * `.safetensors` (what current HF snapshots ship) parsed here, without the
    `safetensors` package: a little-endian u64 header length, a JSON header
    of {name: {dtype, shape, data_offsets}} (plus an optional
    `__metadata__`), then the raw little-endian bytes. The file is
    memory-mapped and each tensor is a `torch.frombuffer` view of it, so a
    loader that carries one tensor at a time to the device never holds a
    second copy of the checkpoint.
"""

from __future__ import annotations

import json
import mmap
import struct
import zipfile
from typing import Dict

import torch

#: safetensors dtype name -> torch dtype (the formats real checkpoints use)
SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """`.safetensors` file -> {name: tensor}, each a view of the mapped file.
    ValueError for a malformed header, an unsupported dtype, or offsets or
    shapes that do not match the file."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        f.seek(0)
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes overruns the {size}-byte file")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: malformed safetensors header: {e}") from None
        # copy-on-write: writable for torch.frombuffer, pages stay the file's
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    start = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta.get('dtype')!r}; "
                             f"supported: {sorted(SAFETENSORS_DTYPES)}")
        shape = [int(s) for s in meta["shape"]]
        lo, hi = (int(o) for o in meta["data_offsets"])
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= lo <= hi or start + hi > size:
            raise ValueError(f"{path}: tensor {name!r} bytes [{lo}, {hi}) overrun the "
                             f"{size - start}-byte data section")
        if hi - lo != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} and dtype {meta['dtype']} "
                             f"needs {count * itemsize} bytes, its offsets give {hi - lo}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + lo) % itemsize:
            # an unaligned view would reach kernels that assume alignment
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=hi - lo, offset=start + lo)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count, offset=start + lo).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict:
    """Checkpoint file -> flat {name: tensor} state_dict."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
