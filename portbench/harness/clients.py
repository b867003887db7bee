"""Stand-ins for the remote VLM and LLM that the ingest engine calls: they
answer at once and from the prompt alone, so their cost is zero and every
run gets the same replies.

  * frame captions: "frame <sha1 of the JPEG>"
  * a caption summary: the `[video ...]` tags of its evidence
  * anything else: a fixed sentence
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence


def _text(messages: List[Dict]) -> str:
    parts = []
    for m in messages:
        c = m.get("content", "")
        if isinstance(c, str):
            parts.append(c)
        else:
            parts += [x.get("text", "") for x in c if isinstance(x, dict) and x.get("type") == "text"]
    return "\n".join(parts)


class StandIn:
    """Reasoning LLM, frame-captioning VLM and summariser in one object."""

    def chat(self, messages: List[Dict], max_tokens: int = 512, temperature: float = 0.0) -> str:
        text = _text(messages)
        if "ummar" in text:  # a caption summary keeps the evidence's video tags
            tags = sorted(set(re.findall(r"\[video ([^\]]+)\]", text)))
            return " ".join(f"[video {t}]" for t in tags) + " A summary of the evidence."
        return "No answer."

    def caption_images(self, jpegs: Sequence[bytes], prompt: str, max_workers: int = 8) -> List[str]:
        return [f"frame {hashlib.sha1(j).hexdigest()[:12]}" if j else "" for j in jpegs]

    def generate(self, prompt, images=None, video_frames=None, max_tokens: int = 512,
                 max_new_tokens=None) -> str:
        return "A synthetic scene with a moving square."
