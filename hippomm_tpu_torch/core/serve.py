"""Persistent QA serving over a memory store (counterpart of
hippomm_tpu/core/serve.py).

The one-shot query CLI (core/ask_question) builds its engine and loads the
store per call. This server loads the models once, keeps a warm
`HippocampalMemory` + `QARecallSystem` resident on the card, and answers
over HTTP with the JAX server's endpoints, JSON shapes and status codes:

    GET  /healthz               -> {"status": "ok", "events": N, "videos": M, "latency_ms": {...}}
    GET  /events                -> event-index listing (index only, no models)
    POST /ask        {"question": str, "reload": bool?}   -> QARecallResult
    POST /ask_batch  {"questions": [str, ...]}            -> {"results": [QARecallResult]}
    POST /ingest     {"path": "/abs/video_or_folder"}     -> ingest stats

    python -m hippomm_tpu_torch.core.serve --memory-store store --port 8080

The engine runs on CUDA unless the caller passes `device` (e.g. "cpu").
Concurrency: stdlib ThreadingHTTPServer runs each request on its own thread;
QA and ingest serialize on one engine lock. Grad mode is per thread, so each
handler enters `torch.no_grad()` itself; the kernel wrappers bind the card's
context in a new thread before their first launch (ops/_native.bind_thread).
`/ingest` runs the ingest CLI's `ingest_single_file` / `process_video_folder`
with the resident engine, so later questions see the new events without a
restart.

One difference from the JAX server, on purpose: the startup warmup question
is not caught. A server whose card, kernels or weights fail on the first
question does not start.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


def _result_dict(r) -> Dict[str, Any]:
    d = dataclasses.asdict(r)
    d.pop("retrieved_segments", None)  # raw segments can embed ndarrays
    d["retrieved_segments"] = len(r.retrieved_segments or [])
    return d


class QAService:
    """The warm engine + recall system behind the HTTP handlers (usable
    in-process too; the HTTP layer is a thin shell around it)."""

    def __init__(self, config, event_id: Optional[str] = None, warm: bool = True, device=None):
        from hippomm_tpu_torch.memory.engine import HippocampalMemory
        from hippomm_tpu_torch.retrieval.qa import QARecallSystem

        self.config = config
        self.lock = threading.Lock()
        self._lat_lock = threading.Lock()
        self._latencies: Dict[str, list] = {}
        self.memory = HippocampalMemory(config=config, device=device)
        if event_id:
            self.memory.load_theta_event(event_id)
        else:
            self.memory.load_all_events()
        self.qa = QARecallSystem(self.memory, config)
        if warm and self.memory.long_term_store:
            # pay the first question's one-time costs (kernel build, the
            # tokenizer and token counter) at startup; a failure stops startup
            with torch.no_grad():
                self.qa.answer_question("What is shown?")

    # ---- handlers (each serializes on the engine lock) ----------------------

    def healthz(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "events": len(self.memory.long_term_store),
            "videos": len(self.memory.store.video_index),
            "latency_ms": self.latency_stats(),
        }

    def latency_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-endpoint latency histogram: p50 / p95 / max / count over a
        bounded window of recent requests."""
        out = {}
        with self._lat_lock:
            for name, window in self._latencies.items():
                if not window:
                    continue
                arr = sorted(window)
                n = len(arr)
                out[name] = {
                    "p50": round(arr[n // 2], 1),
                    "p95": round(arr[min(n - 1, int(n * 0.95))], 1),
                    "max": round(arr[-1], 1),
                    "count": n,
                }
        return out

    def _record(self, name: str, dt_ms: float) -> None:
        with self._lat_lock:
            window = self._latencies.setdefault(name, [])
            window.append(dt_ms)
            if len(window) > 512:
                del window[: len(window) - 512]

    def events(self) -> Dict[str, Any]:
        with self.lock:  # /ingest mutates event_index concurrently
            return {"events": self.memory.store.list_events()}

    def reload(self) -> int:
        """Re-read indices and events from disk (an external writer, another
        server or a batch_process run, may have extended the store)."""
        store = self.memory.store
        store.event_index = store._load_index(store.event_index_path)
        store.video_index = store._load_index(store.video_index_path)
        self.memory.load_all_events()
        self.qa._index_cache.clear()
        return len(self.memory.long_term_store)

    def ask(self, question: str, reload: bool = False) -> Dict[str, Any]:
        t0 = time.perf_counter()
        with self.lock, torch.no_grad():
            if reload:
                self.reload()
            out = _result_dict(self.qa.answer_question(question))
        self._record("ask", (time.perf_counter() - t0) * 1000)
        return out

    def ask_batch(self, questions: Sequence[str]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        with self.lock, torch.no_grad():
            results = self.qa.answer_questions(list(questions))
        self._record("ask_batch_per_q", (time.perf_counter() - t0) * 1000 / max(1, len(questions)))
        return {"results": [_result_dict(r) for r in results]}

    def ingest(self, path: str) -> Dict[str, Any]:
        from hippomm_tpu_torch.core.batch_process import ingest_single_file, process_video_folder

        with self.lock, torch.no_grad():
            ingest = ingest_single_file if os.path.isfile(path) else process_video_folder
            stats = ingest(path, self.config.storage.base_dir, config=self.config,
                           memory_system=self.memory)
            # the resident store already holds the new events (same engine):
            # only the QA index caches are stale
            self.qa._index_cache.clear()
        stats.pop("engine", None)
        return stats


def make_server(service: QAService, host: str = "127.0.0.1", port: int = 8080):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # to logging, not stderr
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            try:
                if self.path == "/healthz":
                    return self._send(200, service.healthz())
                if self.path == "/events":
                    return self._send(200, service.events())
                return self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001 — the server stays up; the error is returned
                logger.exception("GET %s failed", self.path)
                return self._send(500, {"error": repr(e)})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/ask":
                    q = req.get("question")
                    if not q:
                        return self._send(400, {"error": "missing 'question'"})
                    return self._send(200, service.ask(q, reload=bool(req.get("reload"))))
                if self.path == "/ask_batch":
                    qs = req.get("questions")
                    if not qs or not isinstance(qs, list):
                        return self._send(400, {"error": "missing 'questions' list"})
                    return self._send(200, service.ask_batch(qs))
                if self.path == "/ingest":
                    path = req.get("path")
                    if not path:
                        return self._send(400, {"error": "missing 'path'"})
                    return self._send(200, service.ingest(path))
                return self._send(404, {"error": f"unknown path {self.path}"})
            except json.JSONDecodeError as e:
                return self._send(400, {"error": f"bad json: {e}"})
            except Exception as e:  # noqa: BLE001 — a kernel or ingest fault is a 500 with its error
                logger.exception("POST %s failed", self.path)
                return self._send(500, {"error": repr(e)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    from hippomm_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description="hippomm-tpu QA server")
    parser.add_argument("--config", default=None)
    parser.add_argument("--memory-store", "--memory_store", default="memory_store")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--event", default=None, help="serve one event only")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config)
    config.storage.base_dir = args.memory_store
    service = QAService(config, event_id=args.event, device=device)
    server = make_server(service, args.host, args.port)
    logger.info("serving %d events on http://%s:%d", len(service.memory.long_term_store),
                args.host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
