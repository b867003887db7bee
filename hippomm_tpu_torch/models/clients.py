"""VLM/LLM clients: OpenAI-compatible HTTP + deterministic local stubs.

The reference talks to Qwen2.5-VL (vLLM/sglang) and GPT-4o exclusively through
the OpenAI chat-completions protocol (foundation_models.py:217-344;
hippocampal_memory.py:1633-1638). We keep that exact seam, but:

  * no `openai` SDK dependency — a small requests-based client with retry
  * round-robin load balancing across `base_urls` built in (the reference
    hand-rolls `base_urls[index % len(...)]`, hippocampal_memory.py:186-193)
  * a StubClient that answers deterministically from prompt content, so the
    ENTIRE ingest+QA pipeline runs hermetically (the reference hard-fails at
    engine init if the endpoint is down, foundation_models.py:228-231)
  * async fan-out for caption batches via a thread pool (replaces the
    reference's mp.Pool-of-HTTP-calls, hippocampal_memory.py:633-643 — which
    crashes on unpicklable lambdas at :2263)
"""

from __future__ import annotations

import base64
import concurrent.futures
import hashlib
import itertools
import json
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

logger = logging.getLogger(__name__)

Message = Dict[str, Any]


class ChatClient:
    """Abstract chat-completions interface."""

    def chat(
        self,
        messages: List[Message],
        max_tokens: int = 512,
        temperature: float = 0.0,
    ) -> str:
        raise NotImplementedError

    def caption_images(self, jpeg_batches: Sequence[bytes], prompt: str, max_workers: int = 8) -> List[str]:
        """Caption many images concurrently; order-preserving."""

        def one(data: bytes) -> str:
            try:
                return self.chat(
                    [
                        {
                            "role": "user",
                            "content": [
                                {"type": "text", "text": prompt},
                                {
                                    "type": "image_url",
                                    "image_url": {
                                        "url": "data:image/jpeg;base64,"
                                        + base64.b64encode(data).decode()
                                    },
                                },
                            ],
                        }
                    ],
                    max_tokens=128,
                )
            except Exception as e:  # same per-frame placeholder behavior as reference
                logger.warning("caption failed: %s", e)
                return "[Error processing image]"

        if not jpeg_batches:
            return []
        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
            return list(ex.map(one, jpeg_batches))


class OpenAICompatClient(ChatClient):
    """requests-based OpenAI chat-completions client with round-robin over
    multiple base_urls and exponential-backoff retry."""

    def __init__(
        self,
        base_urls: Union[str, Sequence[str]],
        api_key: str = "",
        model_name: Optional[str] = None,
        timeout: float = 120.0,
        max_retries: int = 3,
    ):
        if isinstance(base_urls, str):
            base_urls = [base_urls]
        self.base_urls = [u.rstrip("/") for u in base_urls]
        self.api_key = api_key
        self.timeout = timeout
        self.max_retries = max_retries
        self._rr = itertools.cycle(range(len(self.base_urls)))
        self._rr_lock = threading.Lock()
        self.model_name = model_name or self._discover_model()

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _discover_model(self) -> str:
        """GET /models like the reference's auto-probe (foundation_models.py:228-231)
        — but non-fatal: fall back to a placeholder name."""
        import requests

        for url in self.base_urls:
            try:
                r = requests.get(f"{url}/models", headers=self._headers(), timeout=5)
                data = r.json().get("data", [])
                if data:
                    return data[0]["id"]
            except Exception:
                continue
        logger.warning("model discovery failed for %s; using 'default'", self.base_urls)
        return "default"

    def _next_url(self) -> str:
        with self._rr_lock:
            return self.base_urls[next(self._rr)]

    def chat(self, messages: List[Message], max_tokens: int = 512, temperature: float = 0.0) -> str:
        import requests

        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            url = self._next_url()
            try:
                r = requests.post(
                    f"{url}/chat/completions",
                    headers=self._headers(),
                    json={
                        "model": self.model_name,
                        "messages": messages,
                        "max_tokens": max_tokens,
                        "temperature": temperature,
                    },
                    timeout=self.timeout,
                )
                r.raise_for_status()
                return r.json()["choices"][0]["message"]["content"]
            except Exception as e:
                last_err = e
                if attempt + 1 < self.max_retries:  # no dead sleep after the
                    time.sleep(min(2**attempt, 8))  # final attempt
        raise RuntimeError(f"chat completion failed after {self.max_retries} tries: {last_err}")


class StubClient(ChatClient):
    """Deterministic local stand-in for VLM/LLM endpoints.

    Pattern-matches the framework's own prompt shapes (classification,
    captioning, search-query compression, confidence answers, JSON time
    frames) and returns well-formed responses, so every pipeline path —
    including structured-output parsing — is exercised hermetically."""

    def __init__(self, name: str = "stub"):
        self.name = name
        self.calls: List[Dict[str, Any]] = []

    @staticmethod
    def _text_of(messages: List[Message]) -> str:
        parts = []
        for m in messages:
            c = m.get("content", "")
            if isinstance(c, str):
                parts.append(c)
            else:
                parts.extend(x.get("text", "") for x in c if isinstance(x, dict))
        return "\n".join(parts)

    @staticmethod
    def _has_image(messages: List[Message]) -> bool:
        for m in messages:
            c = m.get("content", "")
            if isinstance(c, list) and any(
                isinstance(x, dict) and x.get("type") == "image_url" for x in c
            ):
                return True
        return False

    def chat(self, messages: List[Message], max_tokens: int = 512, temperature: float = 0.0) -> str:
        text = self._text_of(messages)
        self.calls.append({"text": text[:2000], "images": self._has_image(messages)})
        if len(self.calls) > 512:  # test introspection only — a resident
            # server in stub mode must not grow this forever
            del self.calls[: len(self.calls) - 512]
        lower = text.lower()

        if self._has_image(messages):
            # stable pseudo-caption keyed by image bytes
            h = hashlib.sha1(text.encode()).hexdigest()[:8]
            for m in messages:
                c = m.get("content", "")
                if isinstance(c, list):
                    for x in c:
                        if isinstance(x, dict) and x.get("type") == "image_url":
                            url = x["image_url"]["url"]
                            h = hashlib.sha1(url.encode()).hexdigest()[:8]
            return f"A scene showing synthetic content (frame signature {h})."

        if "classify" in lower and "question:" in lower:
            # classify based on the question text only, not the label glossary
            q = lower.rsplit("question:", 1)[-1]
            if re.search(r"\b(hear|heard|sound|sounds|say|said|speech|voice|audio)\b", q):
                return "AUDIO"
            if re.search(r"\b(overall|summary|summarize|main topic|about)\b", q):
                return "SUMMARY"
            return "VIDEO"
        if "search query" in lower or ("2-5 word" in lower or "short query" in lower):
            words = re.findall(r"[a-z]+", lower.rsplit("question", 1)[-1])[:4]
            return " ".join(words) or "scene content"
        if "primary modality" in lower:
            q = lower.rsplit("question:", 1)[-1]
            if re.search(r"\b(say|said|speak|speaking|talk|talking|mention|discuss|word)\b", q):
                return "speech"
            if re.search(r"\b(sound|noise|hear|heard|melody|music|tone|song|plays?)\b", q):
                return "sound"
            return "video"
        if "json" in lower and ("time" in lower or "frame" in lower):
            return json.dumps([{"start_time": 0.0, "end_time": 5.0}])
        if "confidence" in lower:
            return "ANSWER: Based on the memory store, the content shows synthetic scenes.\nCONFIDENCE: 0.9"
        if "summar" in lower:
            return "A synthetic video of changing colored scenes with periodic tones."
        return "The analyzed content shows synthetic audiovisual scenes."


def _split_messages(messages: List[Message]):
    """(the text parts joined by newlines, the inline images' RGB arrays)."""
    from hippomm_tpu_torch.media.io import jpeg_decode

    texts, images = [], []
    for m in messages:
        c = m.get("content", "")
        if isinstance(c, str):
            texts.append(c)
            continue
        for x in c:
            if not isinstance(x, dict):
                continue
            if x.get("type") == "text":
                texts.append(x.get("text", ""))
            elif x.get("type") == "image_url":
                url = x["image_url"]["url"]
                images.append(jpeg_decode(base64.b64decode(url.split(",", 1)[1])))
    return "\n".join(texts), images


class LocalVLMClient(ChatClient):
    """An in-process VLM (models/kimi_vl.KimiVL) behind the chat surface:
    `caption_images` decodes a call's JPEGs and captions them all as one
    batched generate; `chat` and `generate` (QwenVL's surface, the
    engine's summariser) serve one row. Greedy: `temperature` is ignored."""

    def __init__(self, model):
        self.model = model

    def chat(self, messages: List[Message], max_tokens: int = 512, temperature: float = 0.0) -> str:
        text, images = _split_messages(messages)
        return self.model.complete(text, images, max_tokens)

    def caption_images(self, jpeg_batches: Sequence[bytes], prompt: str, max_workers: int = 8) -> List[str]:
        from hippomm_tpu_torch.media.io import jpeg_decode

        def one(data: bytes):
            try:
                return jpeg_decode(data) if data else None
            except Exception as e:  # the reference's per-frame placeholder
                logger.warning("caption frame unreadable: %s", e)
                return None

        if not jpeg_batches:
            return []
        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
            images = list(ex.map(one, jpeg_batches))
        return self.model.caption(images, prompt, max_tokens=128)

    def generate(self, prompt, images=None, video_frames=None, max_tokens: int = 512,
                 max_new_tokens: Optional[int] = None) -> str:
        """QwenVL.generate's surface: a text prompt, optional JPEG images or
        raw (N, H, W, 3) frames."""
        from hippomm_tpu_torch.media.io import jpeg_decode

        if max_new_tokens is not None:
            max_tokens = max_new_tokens
        if not isinstance(prompt, str):
            return self.chat(prompt, max_tokens=max_tokens)
        rgb = [jpeg_decode(j) for j in images or []]
        if video_frames is not None:
            rgb += list(video_frames)
        return self.model.complete(prompt, rgb, max_tokens)


def make_client(endpoint_cfg, mode: str = "auto", purpose: str = "qwen") -> ChatClient:
    """Factory honoring api.mode: stub | http | auto (auto = http if reachable
    else stub — the reference would hard-crash here instead)."""
    base_urls = getattr(endpoint_cfg, "base_urls", None) or [
        getattr(endpoint_cfg, "base_url", "") or ""
    ]
    base_urls = [u for u in base_urls if u]
    if mode == "stub" or (mode == "auto" and not base_urls):
        return StubClient(purpose)
    if mode == "http":
        if not base_urls:
            # an empty round-robin would raise a bare StopIteration at the
            # FIRST chat() call, far from the misconfiguration
            raise ValueError(
                f"api.mode='http' for {purpose} but no base_url/base_urls configured"
            )
        return OpenAICompatClient(
            base_urls,
            api_key=getattr(endpoint_cfg, "api_key", ""),
            model_name=getattr(endpoint_cfg, "model_name", None) or None,
        )
    # auto: probe EVERY configured endpoint — falling to the stub because
    # only the first one is down defeats the round-robin
    import requests

    live = []
    for u in base_urls:
        try:
            requests.get(u.rstrip("/") + "/models", timeout=2)
            live.append(u)
        except Exception:
            logger.info("%s endpoint %s unreachable", purpose, u)
    if live:
        return OpenAICompatClient(
            live,
            api_key=getattr(endpoint_cfg, "api_key", ""),
            model_name=getattr(endpoint_cfg, "model_name", None) or None,
        )
    logger.info("no %s endpoint reachable; using stub client", purpose)
    return StubClient(purpose)
