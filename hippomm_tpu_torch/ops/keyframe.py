"""Greedy key-frame selection on the device (counterpart of
hippomm_tpu/ops/keyframe.py).

The walk: SSIM each ~1 Hz candidate against the LAST-SAVED frame, keep a
cumulative diff, save on threshold, gated by time since the last save
(`core/batch_process.select_keyframes_greedy` is the host statement of it).
Here it is one block of small torch ops per candidate over a carry that stays
on the device — reference gray, cumulative diff, last-save time, has-ref —
so nothing reads back until a block's save mask is wanted.

On CUDA the scan runs on a stream of its own (one high-priority stream per
device, shared by every scanner, so the caching allocators keep serving its
blocks and no new allocation synchronizes the device mid-ingest). The
extractor polls a block's mask with `is_ready()` (an event query) and reads
it on that stream, so a read never waits behind the vision tower or the
full-track Whisper encoder queued on the default stream. Every tensor of the
scan (the uploaded luma, the carry, the masks) is made and used on the scan
stream; none crosses to another. A device error raises: there is no host
route and no host walk.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from hippomm_tpu_torch.ops.ssim import ssim_pairs
from hippomm_tpu_torch.utils.device import resolve_device

BLOCK = 256

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def scan_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's key-frame scan stream, made on first use."""
    with _streams_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device, priority=-1)
        return _streams[device]


@torch.no_grad()
def _select_block(grays, times, ref, cum, tlast, has_ref, max_diff: float, min_interval: float):
    """One greedy block over the m real rows of (m, h, w) uint8 `grays` and
    their (m,) fp32 `times`: returns (save_mask (m,) int32, ref', cum',
    tlast', has_ref'). The carry is (h, w) fp32 and 0-d fp32 / bool tensors;
    every step is device ops, no host read."""
    saves = []
    for j in range(grays.shape[0]):
        gf = grays[j].float()
        t = times[j]
        is_first = ~has_ref
        gate = has_ref & ((t - tlast) >= min_interval)
        diff = 1.0 - ssim_pairs(ref[None], gf[None])[0]
        cum2 = torch.where(gate, cum + diff, cum)
        save = is_first | (gate & ((diff > max_diff) | (cum2 > max_diff)))
        ref = torch.where(save, gf, ref)
        cum = torch.where(save, torch.zeros_like(cum2), cum2)
        tlast = torch.where(save, t, tlast)
        has_ref = has_ref | save
        saves.append(save)
    return torch.stack(saves).to(torch.int32), ref, cum, tlast, has_ref


class _MaskHandle:
    """Save mask of one fed block: a device tensor until read."""

    def __init__(self, scanner: "KeyframeScanner", mask: torch.Tensor, event):
        self._scanner = scanner
        self._mask = mask
        self._event = event  # CUDA event recorded after the block's scan, or None
        self._val: Optional[np.ndarray] = None

    def is_ready(self) -> bool:
        """True once the mask can be read without waiting on the device."""
        return self._val is not None or self._event is None or self._event.query()

    def get(self) -> np.ndarray:
        if self._val is None:
            self._val = self._scanner._read([self._mask])[0]
            self._mask = None
        return self._val


class KeyframeScanner:
    """Streaming form of the greedy walk: feed candidate blocks as they
    decode; each feed queues the block's scan and returns a handle for its
    save mask. The carry chains on the device between blocks, so the
    extractor decodes block i+1 while the device scans block i, and reads a
    mask (`handle.get()`, or `prefetch_masks` for several) only when it needs
    the kept frames."""

    def __init__(
        self,
        h: int,
        w: int,
        max_diff_threshold: float = 0.3,
        min_interval_s: float = 1.0,
        block: int = BLOCK,
        device=None,
    ):
        self.block = block
        self.device = resolve_device(device)
        self._thr = float(max_diff_threshold)
        self._gap = float(min_interval_s)
        cuda = self.device.type == "cuda"
        self._stream = scan_stream(self.device) if cuda else None
        with self._on_stream():
            self._ref = torch.zeros((h, w), dtype=torch.float32, device=self.device)
            self._cum = torch.zeros((), dtype=torch.float32, device=self.device)
            self._tlast = torch.full((), -1e9, dtype=torch.float32, device=self.device)
            self._has_ref = torch.zeros((), dtype=torch.bool, device=self.device)

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._stream is None:
            return t
        # pinned, so the copy is queued on the scan stream without a wait
        return t.pin_memory().to(self.device, non_blocking=True)

    def feed(self, grays: np.ndarray, times) -> _MaskHandle:
        """Queue the scan of ≤ block candidates ((m, h, w) uint8 luma and
        their times in seconds); returns the handle of its (m,) save mask."""
        if len(grays) > self.block:
            raise ValueError(f"fed {len(grays)} candidates to a {self.block}-candidate scanner")
        with self._on_stream():
            g = self._upload(np.asarray(grays, np.uint8))
            t = self._upload(np.asarray(times, np.float32))
            mask, self._ref, self._cum, self._tlast, self._has_ref = _select_block(
                g, t, self._ref, self._cum, self._tlast, self._has_ref, self._thr, self._gap
            )
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        return _MaskHandle(self, mask, event)

    def _read(self, masks: List[torch.Tensor]) -> List[np.ndarray]:
        """Masks to the host in one copy on the scan stream."""
        with self._on_stream():
            flat = torch.cat(masks) if len(masks) > 1 else masks[0]
            host = flat.cpu().numpy()  # synchronizes the scan stream only
        out, lo = [], 0
        for m in masks:
            out.append(host[lo : lo + m.shape[0]])
            lo += m.shape[0]
        return out

    def prefetch_masks(self, handles) -> None:
        """Read every handle's mask not yet read with ONE device→host copy."""
        todo = [h for h in handles if h._val is None]
        if len(todo) < 2:
            return
        for h, val in zip(todo, self._read([h._mask for h in todo])):
            h._val, h._mask = val, None

    def close(self) -> None:
        self._ref = self._cum = self._tlast = self._has_ref = None


def select_keyframes_device(
    grays: np.ndarray,
    times,
    max_diff_threshold: float = 0.3,
    min_interval_s: float = 1.0,
    block: int = BLOCK,
    device=None,
) -> List[int]:
    """Greedy selection over (N, h, w) uint8 candidates, one scan per
    `block` candidates. Semantics identical to
    core.batch_process.select_keyframes_greedy (the host statement)."""
    n = len(grays)
    if n == 0:
        return []
    h, w = grays.shape[1:]
    t_arr = np.asarray(times, np.float32)
    scanner = KeyframeScanner(h, w, max_diff_threshold, min_interval_s, block, device=device)
    handles = [
        scanner.feed(grays[b0 : min(n, b0 + block)], t_arr[b0 : min(n, b0 + block)])
        for b0 in range(0, n, block)
    ]
    scanner.prefetch_masks(handles)
    mask = np.concatenate([s.get() for s in handles])
    return [int(i) for i in np.nonzero(mask)[0]]
