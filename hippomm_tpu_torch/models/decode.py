"""The captured decode step of the port's generative models (Whisper's
greedy decode, Kimi-VL's buckets), and the cache that keeps it across
decodes.

A model's decode state has `start(*args)`, which refills its buffers,
`step()`, which changes them in place only and returns the logits, and
`done`, a device flag. `StepGraph` steps one state, on CUDA as replays of
a CUDA graph of its step; `GraphCache` keeps one `StepGraph` a key for as
long as the weights it was built over stay where they are.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable

import torch

from hippomm_tpu_torch.parallel import mesh as pmesh
from hippomm_tpu_torch.utils import timers as tracing


class StepGraph:
    """A greedy decode over a `state` whose buffers are kept across decodes.
    On CUDA `step` replays a CUDA graph of `state.step()`, its buffers the
    graph's static inputs and outputs; elsewhere it steps eagerly. The
    graph is captured at the first start, before the state's own start,
    after one warm-up step on a side stream (torch's lazy set-up: cuBLAS
    handles and workspaces), in thread-local mode, since the vision stream
    and JPEG threads launch work on the device meanwhile; each capture
    counts one `<counter>`. It holds the addresses of the weights, which
    `weights` names. `logits` are the last step's."""

    def __init__(self, state, device, weights, counter: str):
        self.state = state
        self.done = self.state.done
        self.device, self.weights, self.counter = device, weights, counter
        self.lock = threading.Lock()
        self.graph = self.logits = None
        self._released = None  # event after the last work on the buffers

    @contextlib.contextmanager
    def held(self):
        """The buffers for one decode: under the lock, and on CUDA with the
        current stream ordered after the previous holder's work."""
        with self.lock:
            if self.device.type != "cuda":
                yield self
                return
            stream = torch.cuda.current_stream(self.device)
            if self._released is not None:
                stream.wait_event(self._released)
            try:
                yield self
            finally:
                self._released = torch.cuda.Event()
                self._released.record(stream)

    def _capture(self) -> None:
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.state.step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self.logits = self.state.step()
        self.graph = graph
        tracing.count(self.counter, 1)

    def start(self, *args) -> None:
        if self.device.type == "cuda" and self.graph is None:
            self._capture()
        self.state.start(*args)  # undoes the warm-up step

    def step(self) -> None:
        if self.graph is None:
            self.logits = self.state.step()
        else:
            self.graph.replay()


class GraphCache(dict):
    """`StepGraph`s kept across decodes, one a key, each capture counted as
    `counter`. An entry holds its state's buffers and, on CUDA, its graph
    and the graph's pool, until it is rebuilt or dropped. A decode holds
    its entry (`StepGraph.held`) for its whole loop, so two threads never
    step one set of buffers at once."""

    def __init__(self, counter: str):
        super().__init__()
        self.counter = counter
        self._lock = threading.Lock()

    def entry(self, key: Hashable, device, weights, make_state: Callable[[], object]) -> StepGraph:
        """The entry of `key`, built over `make_state()` on first use, and
        built anew when the addresses of the tensors of the tree `weights`
        are others than those it was built over: a graph reads its weights
        where they were when it was captured."""
        ptrs = tuple(t.data_ptr() for _, t in pmesh.tree_leaves(weights))
        with self._lock:
            g = self.get(key)
            if g is None or g.weights != ptrs:
                g = self[key] = StepGraph(make_state(), device, ptrs, self.counter)
            return g
