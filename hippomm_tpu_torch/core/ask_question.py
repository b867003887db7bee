"""Query CLI (counterpart of hippomm_tpu/core/ask_question.py; reference:
hippomm/core/ask_question.py:1-99).

Same flags: --config / --memory-store / --question / --questions-file /
--event / --list / --json. Listing and event inspection read the store's
index only; the models load when a question needs them, on CUDA unless the
caller passes `device` (e.g. "cpu").

    python -m hippomm_tpu_torch.core.ask_question --memory-store store --question "What is shown?"
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

from hippomm_tpu_torch.config import load_config
from hippomm_tpu_torch.memory.store import MemoryStore

logger = logging.getLogger(__name__)


def list_events(store: MemoryStore) -> None:
    """(reference: ask_question.py:67-74)"""
    events = store.list_events()
    if not events:
        print("No events in the memory store.")
        return
    print(f"{len(events)} event(s):")
    for eid in events:
        entry = store.event_index.get(eid, {})
        summary = entry.get("summary", "")
        print(f"  {eid}  [{entry.get('start_time', 0):.0f}-{entry.get('end_time', 0):.0f}s]  {summary}")


def load_event(store: MemoryStore, event_id: str) -> None:
    """Pretty-print one event (reference: ask_question.py:28-48)."""
    ev = store.load_theta_event(event_id)
    print(f"Event {ev.event_id} (video {ev.video_id})")
    print(f"  time: {ev.start_time:.1f}-{ev.end_time:.1f}s  modalities: {ev.modalities}")
    print(f"  summary: {ev.summary}")
    for k, v in ev.features.items():
        print(f"  features[{k}]: {v.shape}")
    print(f"  {len(ev.frame_captions)} captions, {len(ev.audio_transcription)} transcript chunks")
    if ev.holistic_audio_transcription:
        print(f"  holistic transcription: {ev.holistic_text()[:200]}")


def _qa_system(config, event_id: Optional[str], device):
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem

    memory = HippocampalMemory(config=config, device=device)
    if event_id:
        memory.load_theta_event(event_id)
    else:
        memory.load_all_events()
    return QARecallSystem(memory, config)


def ask_question(question: str, config, event_id: Optional[str] = None, device=None):
    """(reference: ask_question.py:50-65)"""
    return _qa_system(config, event_id, device).answer_question(question)


def ask_questions(questions: Sequence[str], config, event_id: Optional[str] = None, device=None):
    """Batched QA over one model load: the VIDEO-type searches ride one
    text-tower forward and one (Q, D) @ (D, N) top-k."""
    return _qa_system(config, event_id, device).answer_questions(list(questions))


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """(reference: ask_question.py:76-99)"""
    parser = argparse.ArgumentParser(description="hippomm-tpu memory QA")
    parser.add_argument("--config", default=None)
    parser.add_argument("--memory-store", "--memory_store", default="memory_store")
    parser.add_argument("--question", default=None)
    parser.add_argument(
        "--questions-file",
        default=None,
        help="file with one question per line — answered as ONE batched recall",
    )
    parser.add_argument("--event", default=None, help="restrict to one event / inspect it")
    parser.add_argument("--list", action="store_true", help="list stored events")
    parser.add_argument("--json", action="store_true", help="print the full QARecallResult as JSON")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config)
    config.storage.base_dir = args.memory_store
    store = MemoryStore(args.memory_store)

    if args.list:
        list_events(store)
        return 0
    if args.event and not args.question and not args.questions_file:
        try:
            load_event(store, args.event)
        except KeyError:
            known = ", ".join(store.list_events()) or "(store is empty)"
            print(f"error: unknown event '{args.event}'. Known events: {known}", file=sys.stderr)
            return 1
        return 0
    if args.questions_file:
        with open(args.questions_file) as f:
            questions = [ln.strip() for ln in f if ln.strip()]
        results = ask_questions(questions, config, args.event, device)
        payload = [{"question": q, **r.to_dict()} for q, r in zip(questions, results)]
        if args.json:
            print(json.dumps(payload, indent=2))
        else:
            for item in payload:
                print(f"Q: {item['question']}\nA: {item['answer']}  "
                      f"(conf {item['confidence']:.2f}, {item['question_type']})")
        return 0
    if not args.question:
        parser.error("--question required (or --list / --event / --questions-file)")

    result = ask_question(args.question, config, args.event, device)
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
    else:
        print(f"Answer: {result.answer}")
        print(f"Confidence: {result.confidence:.2f}   type: {result.question_type}   "
              f"direct: {result.used_direct_answer}  reflection: {result.used_reflection}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
