"""QARecallSystem — dual-pathway retrieval (counterpart of
hippomm_tpu/retrieval/qa.py; reference: hippocampal_memory.py:1615-3449).

Flow (reference answer_question :1644-1703):
  1. classify the question → VIDEO / AUDIO / VIDEO+AUDIO / SUMMARY
  2. FAST PATH: direct answer over event summaries + type-conditional detail,
     structured ANSWER/CONFIDENCE parse, accept if SUMMARY or confidence > 0.7
  3. DETAILED RECALL by type:
       VIDEO  — LLM-compressed 2-5 word query → ImageBind text embedding →
                top-k over the packed vision feature store → ±1 s
                windows → frame re-decode + caption → final answer
       AUDIO  — speech: transcripts → LLM JSON time frames (≤5, ±2 s buffer);
                sound: text→audio-feature top-k (< 0.4 gate → transcript LLM
                fallback) → merged windows → audio re-slice → re-transcribe →
                final answer
       VIDEO+AUDIO — primary-modality routing, localize in primary,
                cross-look-up the secondary via *_in_timeframe, answer
  4. empty retrieval → corner-case answer from all summaries/captions/
     transcripts at confidence 0.3
  5. REFLECTION: reconcile direct vs detailed answers

The device work of a question is one text-tower forward and one top-k over
the packed feature store (search.FeatureSearchIndex: K5 for a single query,
one matmul + top-k for a batch); everything LLM-side goes through ChatClient
(HTTP or stub), so the whole system runs hermetically. The index lives on
the engine's device.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hippomm_tpu_torch.config import Config
from hippomm_tpu_torch.memory.schema import QARecallResult, ThetaEvent
from hippomm_tpu_torch.models.clients import ChatClient, make_client
from hippomm_tpu_torch.retrieval.budget import (
    evenly_distribute_items,
    proportional_split,
    subsample_note,
    truncate_text_to_tokens,
)
from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex, SearchHit, merge_windows

logger = logging.getLogger(__name__)

QUESTION_TYPES = ("VIDEO", "AUDIO", "VIDEO+AUDIO", "SUMMARY")


class QARecallSystem:
    def __init__(self, memory, config: Optional[Config] = None, reasoning_client: Optional[ChatClient] = None):
        self.memory = memory
        self.config = config or getattr(memory, "config", None) or Config()
        p = self.config.processing
        self.token_budget = p.token_budget
        self.top_k = p.retrieval_top_k
        self.low_sim_gate = p.low_similarity_gate
        self.confidence_gate = p.fast_path_confidence
        self.recall_dedup = p.recall_dedup_threshold
        self.reasoning = reasoning_client or make_client(
            self.config.api.reasoning, self.config.api.mode, purpose="reasoning"
        )
        self._index_cache: Dict[str, Tuple[int, FeatureSearchIndex]] = {}
        # per-(video, corpus-size) sorted keyframe sidecar for recall windows
        self._kf_cache: Dict[Tuple[str, int], tuple] = {}

    # ------------------------------------------------------------------ events

    @property
    def events(self) -> List[ThetaEvent]:
        return list(getattr(self.memory, "long_term_store", []))

    def _corpus_sig(self, events) -> tuple:
        """Cache-invalidation signature. LENGTH alone goes stale once the
        engine hits max_long_term (evict-oldest + append keeps len constant
        while the content churns — a resident server would serve evicted
        events forever); the last event's id changes on every append."""
        return (len(events), events[-1].event_id if events else None)

    def _index(self, modality: str) -> FeatureSearchIndex:
        events = self.events
        key = modality
        sig = self._corpus_sig(events)
        cached = self._index_cache.get(key)
        if cached and cached[0] == sig:
            return cached[1]
        mesh = getattr(self.memory, "mesh", None)
        if mesh is not None and mesh.devices.size > 1:
            # multi-device engine: the store rows shard over the mesh and a
            # query's top-k runs per shard, re-ranked on the first device
            # (parallel/sharded_store.py): the one-device index's results
            from hippomm_tpu_torch.parallel.sharded_store import ShardedFeatureIndex

            idx: FeatureSearchIndex = ShardedFeatureIndex.build(events, modality, mesh)
        else:
            idx = FeatureSearchIndex.build(events, modality, device=getattr(self.memory, "device", None))
        self._index_cache[key] = (sig, idx)
        return idx

    # ------------------------------------------------------------- entry point

    def answer_question(self, question: str, event_id: Optional[str] = None) -> QARecallResult:
        """(reference: hippocampal_memory.py:1644-1703)"""
        if event_id is not None:
            self.memory.load_theta_event(event_id)
        if not self.events:
            return QARecallResult(
                answer="No memories available.", confidence=0.0, question_type="NONE"
            )

        qtype = self._classify_question_type(question)
        direct_answer, direct_conf = self._try_direct_answer(question, qtype)

        if direct_answer and (qtype == "SUMMARY" or direct_conf > self.confidence_gate):
            return QARecallResult(
                answer=direct_answer,
                confidence=direct_conf,
                reasoning="direct answer over event summaries",
                question_type=qtype,
                used_direct_answer=True,
            )

        return self._finish_question(question, qtype, direct_answer, direct_conf)

    def _finish_question(
        self,
        question: str,
        qtype: str,
        direct_answer: str,
        direct_conf: float,
        hits: Optional[List[SearchHit]] = None,
    ) -> QARecallResult:
        """Detailed pathway + corner-case fallback + reflection — shared by
        answer_question and the batched answer_questions."""
        if qtype == "VIDEO":
            result = self._process_video_query(question, hits=hits)
        elif qtype == "AUDIO":
            result = self._process_audio_query(question)
        else:
            result = self._process_multimodal_query(question)
        result.question_type = qtype

        if not result.retrieved_segments and not result.used_corner_case:
            result = self._handle_multimodal_corner_cases(question)
            result.question_type = qtype

        if direct_answer and result.answer and direct_answer != result.answer:
            result = self._reflect_on_answer(question, direct_answer, direct_conf, result)
        return result

    def answer_questions(self, questions: List[str]) -> List[QARecallResult]:
        """Batched QA — beyond the reference's one-question surface, built for
        benchmark-style serving (e.g. HippoVlog QA sets):

          * LLM-bound stages (classification, direct answers, query
            compression, per-question pathways) run on a thread pool — the
            clients are HTTP/stub, so they overlap freely
          * device-bound stages BATCH: all VIDEO-type questions' compressed
            queries ride ONE text-tower forward and ONE (Q, D) @ (D, N)
            matmul + top-k over the store (FeatureSearchIndex.search_batch —
            a mat-mat, where per-question recall is a mat-vec)

        Per-question results match answer_question()."""
        import concurrent.futures

        if not questions:
            return []
        if not self.events:
            return [
                QARecallResult(answer="No memories available.", confidence=0.0, question_type="NONE")
                for _ in questions
            ]
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(questions)))
        try:
            qtypes = list(pool.map(self._classify_question_type, questions))
            directs = list(pool.map(self._try_direct_answer, questions, qtypes))

            # settle fast-path winners
            results: List[Optional[QARecallResult]] = [None] * len(questions)
            pending: List[int] = []
            for i, (qtype, (ans, conf)) in enumerate(zip(qtypes, directs)):
                if ans and (qtype == "SUMMARY" or conf > self.confidence_gate):
                    results[i] = QARecallResult(
                        answer=ans,
                        confidence=conf,
                        reasoning="direct answer over event summaries",
                        question_type=qtype,
                        used_direct_answer=True,
                    )
                else:
                    pending.append(i)

            # batch the VIDEO-type embedding search
            vid_idx = [i for i in pending if qtypes[i] == "VIDEO"]
            hits_by_q: Dict[int, List[SearchHit]] = {}
            # only pack (and upload) the vision store when a VIDEO question
            # will actually search it
            index = self._index("vision") if vid_idx else None
            if vid_idx and index is not None and len(index):
                compressed = list(
                    pool.map(self._format_search_query, [questions[i] for i in vid_idx])
                )
                embs = self.memory.imagebind.encode_text(compressed)
                batch_hits = index.search_batch(
                    embs, top_k_per_event=self.top_k, global_top_k=self.top_k, window_s=1.0
                )
                gated = list(
                    pool.map(
                        self._gate_video_hits,
                        [questions[i] for i in vid_idx],
                        batch_hits,
                    )
                )
                hits_by_q = dict(zip(vid_idx, gated))

            def finish(i: int) -> QARecallResult:
                ans, conf = directs[i]
                return self._finish_question(
                    questions[i], qtypes[i], ans, conf, hits=hits_by_q.get(i)
                )

            for i, r in zip(pending, pool.map(finish, pending)):
                results[i] = r
            return results  # type: ignore[return-value]
        finally:
            pool.shutdown(wait=False)

    # -------------------------------------------------------------- classifier

    def _classify_question_type(self, question: str) -> str:
        """(reference :1884-1921)"""
        prompt = (
            "Classify this question about a video memory into exactly one of: "
            "VIDEO (visual content), AUDIO (speech or sounds), VIDEO+AUDIO "
            "(needs both), SUMMARY (overall content). Reply with the label only.\n"
            f"Question: {question}"
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=8)
        except Exception:
            logger.exception("classification failed; defaulting to VIDEO+AUDIO")
            return "VIDEO+AUDIO"
        reply = reply.strip().upper().replace(" ", "")
        # longest label first: a "VIDEO+AUDIO" reply contains the substring
        # "VIDEO" and must not be swallowed by the single-modality label
        for qt in sorted(QUESTION_TYPES, key=len, reverse=True):
            if qt in reply:
                return qt
        return "VIDEO+AUDIO"

    # --------------------------------------------------------------- fast path

    def _try_direct_answer(self, question: str, qtype: str) -> Tuple[str, float]:
        """(reference :1923-2062)"""
        events = self.events
        # multi-video stores attribute fast-path evidence to its source video
        # (same honest-attribution deviation as the detailed pathways below —
        # the reference's single-store prompt has no ids, :1923-2062): without
        # it, cross-video aggregation questions ("how many colors in video X")
        # are unanswerable from an otherwise-correct summary prompt
        multi = len({e.video_id for e in events}) > 1
        vtag = (lambda e: f"[video {e.video_id}] ") if multi else (lambda e: "")
        summaries = [
            f"{vtag(e)}[{e.start_time:.0f}-{e.end_time:.0f}s] {e.summary}"
            for e in events if e.summary
        ]
        details: List[str] = []
        budget_parts = proportional_split(self.token_budget // 2, [1.0, 1.0])
        if qtype in ("VIDEO", "VIDEO+AUDIO", "SUMMARY"):
            captions = [f"{vtag(e)}{c}" for e in events for c in e.frame_captions]
            kept, sub = evenly_distribute_items(captions, budget_parts[0], "- {}\n")
            if kept:
                details.append(
                    "Frame captions:\n" + "\n".join(f"- {c}" for c in kept)
                    + ("\n" + subsample_note(len(kept), len(captions)) if sub else "")
                )
        if qtype in ("AUDIO", "VIDEO+AUDIO", "SUMMARY"):
            transcript = " ".join(
                e.holistic_text() or " ".join(e.transcript_texts()) for e in events
            ).strip()
            if transcript:
                details.append(
                    "Audio transcription:\n" + truncate_text_to_tokens(transcript, budget_parts[1])
                )
        prompt = (
            "Answer the question from this video memory. Reply in the form:\n"
            "ANSWER: <answer>\nCONFIDENCE: <0.0-1.0>\n\n"
            "Event summaries:\n" + "\n".join(summaries) + "\n\n" + "\n\n".join(details)
            + f"\n\nQuestion: {question}"
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=256)
        except Exception:
            logger.exception("direct answer failed")
            return "", 0.0
        return self._parse_answer_confidence(reply)

    @staticmethod
    def _parse_answer_confidence(reply: str) -> Tuple[str, float]:
        answer, conf = "", 0.0
        m = re.search(r"ANSWER:\s*(.+?)(?:\n|$)", reply, re.DOTALL)
        if m:
            answer = m.group(1).strip()
        m = re.search(r"CONFIDENCE:\s*([0-9.]+)", reply)
        if m:
            try:
                conf = min(1.0, float(m.group(1)))
            except ValueError:
                conf = 0.0
        if not answer:
            answer = reply.strip()
            conf = min(conf, 0.4)
        return answer, conf

    # ----------------------------------------------------------- video pathway

    def _format_search_query(self, question: str) -> str:
        """LLM-compress the question to a 2-5 word embedding query
        (reference :3102-3125)."""
        prompt = (
            "Compress this question into a short 2-5 word search query describing "
            f"the visual content to find. Reply with the query only.\nQuestion: {question}"
        )
        try:
            q = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=16).strip()
            return q or question
        except Exception:
            return question

    def _find_relevant_video_segments(self, question: str) -> List[SearchHit]:
        """(reference :3127-3279) — top-k + caption-LLM fallback below gate."""
        index = self._index("vision")
        if len(index) == 0:
            return []
        query = self._format_search_query(question)
        # the embedding stays on the device and feeds K5: the query reads
        # back only the top-k
        emb = self.memory.imagebind.encode_text_device([query])[0]
        hits = index.search(emb, top_k_per_event=self.top_k, global_top_k=self.top_k, window_s=1.0)
        return self._gate_video_hits(question, hits)

    def _gate_video_hits(self, question: str, hits: List[SearchHit]) -> List[SearchHit]:
        if hits and max(h.similarity for h in hits) >= self.low_sim_gate:
            return hits
        return self._caption_selection_fallback(question) or hits

    def _caption_selection_fallback(self, question: str) -> List[SearchHit]:
        """Low-similarity fallback: ask the LLM to pick caption indices
        (reference :3156-3257, incl. off-by-one fix at :3229)."""
        entries = []
        for e in self.events:
            for i, c in enumerate(e.frame_captions):
                t = e.frame_times[i] if i < len(e.frame_times) else e.start_time
                entries.append((e, i, t, c))
        if not entries:
            return []
        listing = [f"{i}: {c}" for i, (_, _, _, c) in enumerate(entries)]
        kept, _ = evenly_distribute_items(listing, self.token_budget // 4, "{}\n")
        prompt = (
            "Below are numbered frame captions from a video. Return the indices "
            "(JSON list of integers, max 5) of the frames most relevant to the "
            f"question.\n\n" + "\n".join(kept) + f"\n\nQuestion: {question}"
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=64)
            idx = [int(i) for i in json.loads(re.search(r"\[.*?\]", reply, re.DOTALL).group(0))]
        except Exception:
            idx = list(range(min(self.top_k, len(entries))))  # fallback-to-top-k (:3243-3257)
        hits = []
        for i in idx[: self.top_k]:
            if 0 <= i < len(entries):
                e, iei, t, _ = entries[i]
                hits.append(
                    SearchHit(e.event_id, e.video_id, t, 0.0, iei, (max(0.0, t - 1.0), t + 1.0))
                )
        return hits

    def _frames_for_windows(
        self, video_id: str, windows: Sequence[Tuple[float, float]], fps: float = 1.0,
        source_times: Optional[List[float]] = None,
    ) -> Tuple[List[bytes], List[float]]:
        """Frames inside the windows at ~1 fps, 320×180, with the reference's
        keep-if-changed dedup (reference :2210-2251 — cv2 seek loops re-decoding
        the source mp4 around every hit).

        Fast path: samples covered by a persisted keyframe (the
        direction-aware rule below — the at-or-before keyframe covers until
        the NEXT save) read that JPEG instead of paying an H.264
        keyframe-seek + decode-forward; only samples before the first
        keyframe touch the source video, whose decoding comes with the
        port's media shim (until then its samples fall back to the nearest
        stored keyframe)."""
        from hippomm_tpu_torch.media.io import jpeg_encode, open_video, probe_video, read_jpeg

        path = None
        store = getattr(self.memory, "store", None)
        if store is not None:
            path = store.video_path(video_id)
        times: List[float] = []
        for s, e in windows:
            t = s
            while t <= e:
                times.append(t)
                t += 1.0 / fps
        if not times:
            return [], []

        # stored keyframes for this video, sorted by time — cached per
        # (video, corpus size) like _index_cache: rebuilding + sorting
        # thousands of (time, path) pairs on EVERY window fetch is O(F log F)
        # host work on the <200 ms recall path
        kf_key = (video_id, self._corpus_sig(self.events))
        cached = self._kf_cache.get(kf_key)
        if cached is None:
            ev_frames = []
            for e in self.events:
                if e.video_id == video_id:
                    ev_frames += [
                        (float(t), p) for t, p in zip(e.frame_times, e.frames) if p
                    ]
            ev_frames.sort()
            cached = (ev_frames, np.asarray([t for t, _ in ev_frames]))
            # corpus change invalidates every cached video at once
            cur = self._corpus_sig(self.events)
            self._kf_cache = {
                k: v for k, v in self._kf_cache.items() if k[1] == cur
            }
            self._kf_cache[kf_key] = cached
        ev_frames, kf_times = cached

        # Direction-aware keyframe substitution. The extractor keeps a frame
        # whenever content drifts past the keep threshold vs the LAST KEPT
        # frame (ops/keyframe.py greedy scan), so between consecutive saves
        # content stays within that gate of keyframe j — substituting kf_j
        # for ANY t in [kf_j, kf_{j+1}) yields the frame the recall dedup
        # below would have collapsed a true decode onto anyway. The latest
        # keyframe at-or-before t therefore covers t all the way to the next
        # save (not just one sample period; the only stale slice is the
        # ≤min_interval blackout after an in-blackout cut, and the back rule
        # covers its tail). A LATER keyframe covers t only within half a
        # period (grid jitter: t is essentially ON it) — substituting it
        # further back would show post-cut content for a pre-cut sample,
        # since a later save often marks exactly that cut. Only samples
        # BEFORE the first keyframe decode from the source video, which
        # keeps the H.264 seek+decode out of virtually every recall.
        back_tol = 0.5 / fps
        # (time, kind, path-or-time, source_time) — source_time is the
        # substituted keyframe's OWN capture time (== time for true decodes),
        # kept so evidence can distinguish "captured at t" from "content
        # unchanged since the keyframe at st"
        plan: List[Tuple[float, str, object, float]] = []
        seen_src = set()
        for t in times:
            src = None
            if len(kf_times):
                j = int(np.searchsorted(kf_times, t, side="right")) - 1
                best = None
                fwd_ok = j >= 0
                back_ok = j + 1 < len(kf_times) and kf_times[j + 1] - t <= back_tol
                if fwd_ok and back_ok:
                    # both cover t: the NEARER keyframe is the best guess (a
                    # nearer save is on t's side of a uniformly-placed cut
                    # more often). Fixes post-cut samples riding a stale
                    # pre-cut JPEG when a fresher post-cut save sits ahead.
                    best = j if t - kf_times[j] <= kf_times[j + 1] - t else j + 1
                elif fwd_ok:
                    best = j
                elif back_ok:
                    best = j + 1
                elif path is None:  # degraded store: nearest JPEG beats nothing
                    cands = [c for c in (j, j + 1) if 0 <= c < len(kf_times)]
                    best = min(cands, key=lambda c: abs(kf_times[c] - t))
                if best is not None:
                    # report the SAMPLE time, not the keyframe's: with
                    # coverage extending to the next save, the keyframe may
                    # sit well before the asked window, and the caption
                    # evidence must timestamp the moment the window asked
                    # about (the content is unchanged between saves, so the
                    # caption is valid at t)
                    src = ("jpg", ev_frames[best][1], t, float(kf_times[best]))
            if src is None and path is not None:
                src = ("vid", t, t, t)
            if src is None:
                continue
            key = (src[0], src[1])
            if key in seen_src:  # same keyframe/sample hit twice across windows
                continue
            seen_src.add(key)
            plan.append((src[2], src[0], src[1], src[3]))
        if not plan:
            return [], []
        plan.sort()

        # one batched mp4 decode for the residual samples (if any)
        vid_times = [s for _, kind, s, _ in plan if kind == "vid"]
        decoded: Dict[float, np.ndarray] = {}
        if vid_times:
            try:
                info = probe_video(path)
                r = open_video(path)
                idx = [
                    min(info.num_frames - 1, max(0, int(round(t * info.fps))))
                    for t in vid_times
                ]
                rgb = r.read_rgb(idx)
                r.close()
                decoded = dict(zip(vid_times, rgb))
            except (OSError, ValueError):
                decoded = {}

        frames_list: List[np.ndarray] = []
        kept_times: List[float] = []
        kept_src: List[float] = []
        # keyframes already consumed by 'jpg' plan entries: the decode-failure
        # fallback must not re-emit one of them as a second (identically
        # timestamped) frame — downstream SSIM dedup only compares against the
        # LAST kept frame, so an intervening distinct frame would let the
        # duplicate survive into a wasted VLM caption call
        kf_idx_by_path = {p: i for i, (_, p) in enumerate(ev_frames)}
        used_kf = {
            kf_idx_by_path[p] for _, kind, p, _ in plan if kind == "jpg" and p in kf_idx_by_path
        }
        for t, kind, s, st in plan:
            if kind == "jpg":
                try:
                    frames_list.append(read_jpeg(s))
                except OSError:
                    continue
            elif s in decoded:
                frames_list.append(decoded[s])
            elif len(kf_times):
                # mp4 decode failed (source moved/corrupt): degrade to the
                # nearest stored keyframe regardless of distance — approximate
                # captions beat an empty retrieval
                j = int(np.searchsorted(kf_times, t))
                cands = [c for c in (j - 1, j) if 0 <= c < len(kf_times)]
                best = min(cands, key=lambda c: abs(kf_times[c] - t))
                if best in used_kf:
                    continue
                used_kf.add(best)
                try:
                    frames_list.append(read_jpeg(ev_frames[best][1]))
                    t = st = float(kf_times[best])
                except OSError:
                    continue
            else:
                continue
            kept_times.append(t)
            kept_src.append(st)
        if not frames_list:
            return [], []
        frames = frames_list
        times = kept_times

        from hippomm_tpu_torch.media.io import downscale_rgb, _luma_u8
        from hippomm_tpu_torch.ops.ssim import ssim_pairs_host

        # all host: the frames were just decoded here and the batch is a
        # handful of 180x320 thumbnails
        small = downscale_rgb(np.asarray(frames), 180, 320)
        # reference dedup gate (hippocampal_memory.py:2236-2239): a frame is
        # kept only when its SSIM vs the LAST KEPT frame is <= the threshold
        # (default 0.3) — a static window contributes exactly one frame, so a
        # recall pays one caption call per visually distinct moment
        keep = [0]
        if len(small) > 1:
            gray = _luma_u8(small).astype(np.float32)
            last = 0
            for i in range(1, len(small)):
                s = float(
                    ssim_pairs_host(
                        gray[last : last + 1], gray[i : i + 1], dtype=np.float32
                    )[0]
                )
                if s <= self.recall_dedup:
                    keep.append(i)
                    last = i
        if source_times is not None:
            source_times.extend(kept_src[i] for i in keep)
        return [jpeg_encode(small[i]) for i in keep], [times[i] for i in keep]

    def _process_video_query(
        self, question: str, hits: Optional[List[SearchHit]] = None
    ) -> QARecallResult:
        """(reference :2155-2325); `hits` can be precomputed (batched recall)."""
        if hits is None:
            hits = self._find_relevant_video_segments(question)
        if not hits:
            return QARecallResult(answer="", confidence=0.0, primary_modality="video")
        windows_by_video: Dict[str, List[Tuple[float, float]]] = {}
        for h in hits:
            windows_by_video.setdefault(h.video_id, []).append(h.window)
        # Multi-video stores attribute every evidence line to its source video
        # so cross-video questions ("which video shows X and Y?") are
        # answerable from the prompt; per-video timelines restart at 0, so a
        # bare timestamp is ambiguous the moment a second video exists. The
        # reference stores video_id per event (hippocampal_memory.py:339) but
        # never surfaces it to the answer prompt. Single-video stores keep the
        # exact reference evidence format.
        multi = len({e.video_id for e in self.events}) > 1

        def _decode_and_caption(item) -> List[str]:
            vid, ws = item
            srcs: List[float] = []
            jpegs, times = self._frames_for_windows(
                vid, merge_windows(ws), source_times=srcs
            )
            caps = self._caption_frames(jpegs)
            # a substituted keyframe far from the sample time is labeled with
            # its own capture time, so evidence never asserts a frame was
            # decoded at a moment it wasn't — content is
            # unchanged between saves, hence "since"
            tag = f"[video {vid}] " if multi else ""
            return [
                f"{tag}[{t:.1f}s] {c}" if abs(st - t) <= 1.0
                else f"{tag}[{t:.1f}s (since keyframe {st:.1f}s)] {c}"
                for t, st, c in zip(times, srcs, caps)
            ]

        captions: List[str] = []
        if len(windows_by_video) > 1:
            # multi-video hit sets: video B's frame fetch overlaps video A's
            # (HTTP) captioning — both sides release the GIL
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(4, len(windows_by_video))
            ) as pool:
                for caps in pool.map(_decode_and_caption, windows_by_video.items()):
                    captions += caps
        else:
            for item in windows_by_video.items():
                captions += _decode_and_caption(item)
        if len(captions) > 10:
            summarized = self._summarize_captions(captions, question)
            if summarized:
                captions = [summarized]
            elif len(captions) > 200:
                # summarization failed on a huge caption set: split-summarize
                # halves and stitch (reference :2279-2285)
                mid = len(captions) // 2
                first = self._summarize_captions(captions[:mid], question) or "\n".join(
                    captions[:mid]
                )
                second = self._summarize_captions(captions[mid:], question) or "\n".join(
                    captions[mid:]
                )
                captions = [f"First part:\n{first}", f"Second part:\n{second}"]
            else:
                # summarization failed on a mid-size set: keep raw captions
                # but budget-trim so the final-answer prompt can't blow the
                # token budget summarization exists to enforce
                captions, _ = evenly_distribute_items(
                    captions, self.token_budget // 4, "- {}\n"
                )
        answer, conf = self._final_answer(question, captions=captions)
        return QARecallResult(
            answer=answer,
            confidence=conf,
            reasoning="detailed video recall",
            retrieved_segments=[h.__dict__ for h in hits],
            primary_modality="video",
            segments_analyzed=len(hits),
        )

    def _caption_frames(self, jpegs: List[bytes]) -> List[str]:
        client = getattr(self.memory, "frame_client", None) or self.reasoning
        return client.caption_images(jpegs, "Describe this image in one concise sentence.")

    def _summarize_captions(self, captions: List[str], question: str = "") -> str:
        """(reference :3430-3449 — question-conditioned; empty string on
        failure so the caller can fall back / split-summarize)"""
        kept, _ = evenly_distribute_items(captions, self.token_budget // 4, "- {}\n")
        prompt = (
            "Summarize these frame captions into a short paragraph"
            + (f", keeping details relevant to: {question}" if question else "")
            + ":\n"
            + "\n".join(kept)
        )
        try:
            return self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=256)
        except Exception:
            logger.exception("caption summarization failed")
            return ""

    def _final_answer(
        self,
        question: str,
        captions: Sequence[str] = (),
        transcripts: Sequence[str] = (),
        extra: str = "",
    ) -> Tuple[str, float]:
        """(reference _format_final_answer_prompt :3390-3428)"""
        parts = []
        if captions:
            parts.append("Relevant frame captions:\n" + "\n".join(f"- {c}" for c in captions))
        if transcripts:
            parts.append("Relevant audio transcription:\n" + " ".join(transcripts))
        if extra:
            parts.append(extra)
        prompt = (
            "Using only the retrieved evidence below, answer the question. Reply as:\n"
            "ANSWER: <answer>\nCONFIDENCE: <0.0-1.0>\n\n"
            + "\n\n".join(parts)
            + f"\n\nQuestion: {question}"
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=256)
        except Exception:
            logger.exception("final answer failed")
            return "", 0.0
        return self._parse_answer_confidence(reply)

    # ----------------------------------------------------------- audio pathway

    def _gather_transcripts(self) -> List[Tuple[float, float, str, str]]:
        """(start, end, text, video_id) snippets across all events.

        Entries carry their own start/end (timestamped-entry schema); only
        LEGACY entries missing an 'end' span to the NEXT snippet's start (or
        the event end) — never the reference's flat start+5 s default
        (hippocampal_memory.py:2340-2345), which systematically truncates
        speech-window localization for content in the back half of a
        segment."""
        def spans(entries, event):
            """(start, end, text) per entry; a missing 'end' (legacy string
            lists normalize to text+start only) runs to the NEXT entry's
            start, or the event end — never a flat +5 s."""
            es = [
                (float(tr.get("start", event.start_time)), tr)
                for tr in entries
                if tr.get("text")
            ]
            es.sort(key=lambda p: p[0])
            res = []
            for i, (st, tr) in enumerate(es):
                if "end" in tr:
                    en = float(tr["end"])
                else:
                    en = es[i + 1][0] if i + 1 < len(es) else float(event.end_time)
                res.append((st, max(en, st + 0.5), tr["text"]))
            return res

        out = []
        for e in self.events:
            entries = e.holistic_audio_transcription
            if entries and len(entries) == 1 and e.audio_transcription:
                # a single whole-event-span holistic entry is a normalized
                # LEGACY flat string — the per-segment entries (which old
                # stores always also carry) localize strictly better
                st = float(entries[0].get("start", e.start_time))
                en = float(entries[0].get("end", e.end_time))
                if st <= e.start_time + 1e-6 and en >= e.end_time - 1e-6:
                    entries = e.audio_transcription
            if not entries:
                # sentence-level whole-track entries carry REAL start/end —
                # the finest localization available (reference prefers these,
                # hippocampal_memory.py:2333-2345); fall back to the
                # per-ASR-segment entries
                entries = e.audio_transcription
            for st, en, txt in spans(entries, e):
                out.append((st, en, txt, e.video_id))
        return sorted(out)

    def _attribute_window(
        self, start: float, end: float, transcripts: Sequence[Tuple[float, float, str, str]]
    ) -> str:
        """video_id of the transcript snippet best overlapping [start, end] —
        per-window attribution instead of blaming events[0] (multi-video
        stores would otherwise re-transcribe the wrong video's audio).
        Overlap is normalized by snippet span: a tight snippet precisely at
        the window beats a segment-length snippet that merely contains it."""
        best, best_score = "", -1e18
        for s, e, _, vid in transcripts:
            ov = min(end, e) - max(start, s)
            score = ov / max(e - s, 1e-6) if ov > 0 else ov
            if score > best_score:
                best, best_score = vid, score
        return best or (self.events[0].video_id if self.events else "")

    def _speech_timeframes(self, question: str) -> List[Tuple[float, float, str]]:
        """LLM JSON time-frames over transcripts, each attributed to the video
        whose transcript it overlaps (reference :2330-2428).

        Beyond the reference: snippets are numbered and the LLM is asked to
        cite which snippet each window came from. Timestamps are PER-VIDEO, so
        in a multi-video store a bare (start, end) is ambiguous — two videos
        both have a t≈0 — and overlap attribution alone picks whichever video
        comes first. The cited snippet resolves the video exactly; a reply
        without "snippet" (or with a stale index) falls back to the overlap
        heuristic, so single-video behavior is unchanged."""
        transcripts = self._gather_transcripts()
        if not transcripts:
            return []
        listing = [
            f"{i}: [{s:.1f}-{e:.1f}s] {t}"
            for i, (s, e, t, _) in enumerate(transcripts)
        ]
        kept, _ = evenly_distribute_items(listing, self.token_budget // 3, "{}\n")
        prompt = (
            "Given these numbered, timestamped transcript snippets, return a "
            "JSON list (max 5) of time frames relevant to the question, "
            "citing the snippet number each frame came from, e.g. "
            '[{"start_time": 1.0, "end_time": 4.0, "snippet": 3}].\n\n'
            + "\n".join(kept)
            + f"\n\nQuestion: {question}"
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=192)
            frames = json.loads(re.search(r"\[.*\]", reply, re.DOTALL).group(0))
            out = []
            for fr in frames[:5]:
                s = float(fr.get("start_time", 0.0)) - 2.0  # ±2 s buffer
                e = float(fr.get("end_time", 0.0)) + 2.0
                if e > s:
                    s = max(0.0, s)
                    vid = ""
                    idx = fr.get("snippet")
                    if isinstance(idx, (int, float)) and 0 <= int(idx) < len(transcripts):
                        vid = transcripts[int(idx)][3]
                    out.append(
                        (s, e, vid or self._attribute_window(s, e, transcripts))
                    )
            return out
        except Exception:
            logger.warning("speech timeframe parse failed; using transcript times")
            return [
                (max(0.0, s - 2.0), e + 2.0, vid) for s, e, _, vid in transcripts[:5]
            ]

    def _find_relevant_audio_segments(self, question: str) -> List[SearchHit]:
        """Sound path: text→audio-feature top-k with transcript fallback below
        the similarity gate (reference :3281-3383)."""
        index = self._index("audio")
        if len(index) == 0:
            return []
        emb = self.memory.imagebind.encode_text([self._format_search_query(question)])[0]
        hits = index.search(emb, top_k_per_event=self.top_k, global_top_k=self.top_k, window_s=2.0)
        if hits and max(h.similarity for h in hits) >= self.low_sim_gate:
            return hits
        frames = self._speech_timeframes(question)
        if frames:
            return [SearchHit("", vid, (s + e) / 2, 0.0, -1, (s, e)) for s, e, vid in frames]
        return hits

    def _transcribe_clips(self, clips: Sequence[np.ndarray]) -> List[List]:
        """Batched re-transcription when the ASR backend supports it."""
        wb = getattr(self.memory.whisper, "transcribe_batch", None)
        if wb is not None:
            return wb(clips)
        return [self.memory.whisper.transcribe(c) for c in clips]

    def _audio_for_windows(
        self, video_id: str, windows: Sequence[Tuple[float, float]], sample_rate: int = 16000
    ) -> List[np.ndarray]:
        """Re-slice source audio per window (reference ffmpeg trims :3044-3100;
        here numpy slices of the stored 16 kHz track)."""
        pcm = None
        full = getattr(self.memory, "_full_audio", {})
        if video_id in full:
            pcm = full[video_id]
        else:
            store = getattr(self.memory, "store", None)
            if store is not None:
                import os

                cand = os.path.join(store.audio_dir, video_id, "audio.npy")
                if os.path.exists(cand):
                    pcm = np.load(cand)
        if pcm is None:
            return []
        return [
            pcm[int(s * sample_rate) : int(e * sample_rate)]
            for s, e in windows
            if int(e * sample_rate) > int(s * sample_rate)
        ]

    def _process_audio_query(
        self, question: str, primary_modality: Optional[str] = None
    ) -> QARecallResult:
        """(reference :2327-2521; speech-vs-sound routing comes from the LLM's
        _determine_primary_modality verdict, as at :1684-1686 — a keyword regex
        would misroute e.g. "what melody plays?" away from the sound path)"""
        if primary_modality is None:
            primary_modality = self._determine_primary_modality(question)
        is_speech = primary_modality == "speech"
        if is_speech:
            frames = self._speech_timeframes(question)
            hits = [SearchHit("", vid, (s + e) / 2, 0.0, -1, (s, e)) for s, e, vid in frames]
        else:
            hits = self._find_relevant_audio_segments(question)
        if not hits:
            return QARecallResult(answer="", confidence=0.0, primary_modality="speech" if is_speech else "sound")
        # merge windows PER VIDEO and only re-transcribe that video's audio
        windows_by_video: Dict[str, List[Tuple[float, float]]] = {}
        for h in hits:
            vid = h.video_id or (self.events[0].video_id if self.events else "")
            windows_by_video.setdefault(vid, []).append(h.window)
        windows: List[Tuple[float, float]] = []
        seg_records: List[Dict] = []
        transcripts: List[str] = []
        clips: List[np.ndarray] = []
        for vid, ws in windows_by_video.items():
            merged = merge_windows(ws, gap=2.0)
            windows += merged
            seg_records += [{"window": w, "video_id": vid} for w in merged]
            clips += [c for c in self._audio_for_windows(vid, merged) if len(c) >= 1600]
        if clips:
            for segs in self._transcribe_clips(clips):
                transcripts += [s.text for s in segs if s.text]
        if not transcripts:  # fall back to stored transcripts inside windows
            for s, e, txt, vid in self._gather_transcripts():
                vws = windows_by_video.get(vid, [])
                # true interval overlap — endpoint-only tests dropped a
                # snippet that fully CONTAINS the window (whole-event
                # holistic entries on legacy stores)
                if any(s <= we and e >= ws for ws, we in vws):
                    transcripts.append(txt)
        answer, conf = self._final_answer(question, transcripts=transcripts)
        return QARecallResult(
            answer=answer,
            confidence=conf,
            reasoning="detailed audio recall",
            retrieved_segments=seg_records,
            primary_modality="speech" if is_speech else "sound",
            segments_analyzed=len(windows),
        )

    # ------------------------------------------------------ multimodal pathway

    def _determine_primary_modality(self, question: str) -> str:
        """(reference :2964-3018)"""
        prompt = (
            "For this question, which primary modality should be localized first: "
            "video, speech, or sound? Reply with one word.\nQuestion: " + question
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=4).lower()
        except Exception:
            return "video"
        for m in ("video", "speech", "sound"):
            if m in reply:
                return m
        return "video"

    def _process_multimodal_query(self, question: str) -> QARecallResult:
        """(reference :2724-2962)"""
        primary = self._determine_primary_modality(question)
        if primary in ("speech", "sound"):
            audio_res = self._process_audio_query(question, primary_modality=primary)
            # cross-lookup frames in the SAME video each window came from
            win_by_vid: Dict[str, List[Tuple[float, float]]] = {}
            for s in audio_res.retrieved_segments:
                if "window" in s:
                    vid = s.get("video_id") or (self.events[0].video_id if self.events else "")
                    win_by_vid.setdefault(vid, []).append(tuple(s["window"]))
            # same multi-video attribution rule as _process_video_query:
            # per-video timelines restart at 0, so evidence names its video
            multi = len({e.video_id for e in self.events}) > 1
            captions: List[str] = []
            for vid, ws in win_by_vid.items():
                srcs: List[float] = []
                jpegs, times = self._frames_for_windows(vid, ws, source_times=srcs)
                caps = self._caption_frames(jpegs)
                tag = f"[video {vid}] " if multi else ""
                captions += [
                    f"{tag}[{t:.1f}s] {c}" if abs(st - t) <= 1.0
                    else f"{tag}[{t:.1f}s (since keyframe {st:.1f}s)] {c}"
                    for t, st, c in zip(times, srcs, caps)
                ]
            # the answer stage gets the audio-localized WINDOWS alongside the
            # timed captions: the reference's temporally-aligned prompt
            # (:2853-2860) ships caption times but never says where the audio
            # content was — leaving "while X played, what was seen?" formally
            # unanswerable from its own evidence. Each window carries the
            # ±2 s localization buffer, and saying so lets the reasoner
            # discount edge-of-window bleed.
            win_parts = []
            for vid, ws in win_by_vid.items():
                tag = f"[video {vid}] " if multi else ""
                win_parts += [f"{tag}{s:.1f}-{e:.1f}s" for s, e in ws]
            extra_parts = []
            if win_parts:
                extra_parts.append(
                    "Audio-localized windows (each includes a +-2 s buffer): "
                    + "; ".join(win_parts)
                )
            if audio_res.answer:
                extra_parts.append("Audio-derived answer: " + audio_res.answer)
            answer, conf = self._final_answer(
                question,
                captions=captions,
                extra="\n".join(extra_parts),
            )
            return QARecallResult(
                answer=answer,
                confidence=max(conf, audio_res.confidence * 0.8),
                reasoning=f"multimodal recall, {primary}-first",
                retrieved_segments=audio_res.retrieved_segments,
                primary_modality=primary,
                segments_analyzed=audio_res.segments_analyzed,
            )
        video_res = self._process_video_query(question)
        # cross-lookup audio in the SAME video each visual hit came from
        win_by_vid: Dict[str, List[Tuple[float, float]]] = {}
        for s in video_res.retrieved_segments:
            if "window" in s:
                vid = s.get("video_id") or (self.events[0].video_id if self.events else "")
                win_by_vid.setdefault(vid, []).append(tuple(s["window"]))
        clips: List[np.ndarray] = []
        for vid, ws in win_by_vid.items():
            clips += [
                c
                for c in self._audio_for_windows(vid, merge_windows(ws, gap=2.0))
                if len(c) >= 1600
            ]
        transcripts: List[str] = []
        for segs in self._transcribe_clips(clips) if clips else []:
            transcripts += [s.text for s in segs if s.text]
        answer, conf = self._final_answer(
            question,
            transcripts=transcripts,
            extra="Video-derived answer: " + video_res.answer if video_res.answer else "",
        )
        return QARecallResult(
            answer=answer,
            confidence=max(conf, video_res.confidence * 0.8),
            reasoning="multimodal recall, video-first",
            retrieved_segments=video_res.retrieved_segments,
            primary_modality="video",
            segments_analyzed=video_res.segments_analyzed,
        )

    # ------------------------------------------------------------ corner cases

    def _handle_multimodal_corner_cases(self, question: str) -> QARecallResult:
        """Empty-retrieval fallback: answer from everything at confidence 0.3
        (reference :2623-2721)."""
        events = self.events
        summaries = [e.summary for e in events if e.summary]
        timed = []
        for e in events:
            timed += list(zip(e.frame_times, e.frame_captions))
        # numeric sort BEFORE formatting: "[100.0s]" < "[20.0s]"
        # lexicographically, which scrambled the timeline and skewed the
        # even-spaced subsample
        timed.sort(key=lambda tc: float(tc[0]))
        captions = [f"[{t:.1f}s] {c}" for t, c in timed]
        kept_caps, _ = evenly_distribute_items(captions, self.token_budget // 3, "- {}\n")
        transcript = " ".join(
            e.holistic_text() or " ".join(e.transcript_texts()) for e in events
        )
        answer, conf = self._final_answer(
            question,
            captions=kept_caps,
            transcripts=[truncate_text_to_tokens(transcript, self.token_budget // 3)]
            if transcript.strip()
            else (),
            extra="Event summaries:\n" + "\n".join(summaries),
        )
        return QARecallResult(
            answer=answer,
            confidence=min(conf, 0.3),
            reasoning="corner-case answer from full memory sweep",
            used_corner_case=True,
        )

    # -------------------------------------------------------------- reflection

    def _reflect_on_answer(
        self, question: str, direct: str, direct_conf: float, detailed: QARecallResult
    ) -> QARecallResult:
        """Reconcile fast-path vs detailed answers (reference :1705-1882)."""
        agree_prompt = (
            "Do these two answers to the same question agree? Reply YES or NO.\n"
            f"Question: {question}\nAnswer A: {direct}\nAnswer B: {detailed.answer}"
        )
        try:
            agree = "YES" in self.reasoning.chat(
                [{"role": "user", "content": agree_prompt}], max_tokens=4
            ).upper()
        except Exception:
            agree = False
        if agree:
            detailed.confidence = max(detailed.confidence, direct_conf)
            detailed.used_reflection = True
            return detailed
        # arbitration with sampled context: captions AND transcriptions
        # (reference samples both, hippocampal_memory.py:1790-1860)
        captions = [c for e in self.events for c in e.frame_captions]
        kept, _ = evenly_distribute_items(captions, self.token_budget // 4, "- {}\n")
        trans = [
            f"[{s:.1f}-{e:.1f}s] {t}" for s, e, t, _ in self._gather_transcripts()
        ]
        kept_trans, _ = evenly_distribute_items(trans, self.token_budget // 4, "- {}\n")
        prompt = (
            "Two answers disagree. Using the context, pick the better one. "
            "Reply exactly 'A' or 'B' then a colon and the final answer text.\n"
            f"Question: {question}\nAnswer A: {direct}\nAnswer B: {detailed.answer}\n"
            "Context captions:\n" + "\n".join(kept)
            + ("\nContext transcriptions:\n" + "\n".join(kept_trans) if kept_trans else "")
        )
        try:
            reply = self.reasoning.chat([{"role": "user", "content": prompt}], max_tokens=128)
        except Exception:
            detailed.used_reflection = True
            return detailed
        choice = reply.strip()[:1].upper()
        if choice == "A":
            return QARecallResult(
                answer=direct,
                confidence=direct_conf,
                reasoning="reflection chose direct answer",
                retrieved_segments=detailed.retrieved_segments,
                question_type=detailed.question_type,
                used_direct_answer=True,
                used_reflection=True,
                primary_modality=detailed.primary_modality,
                segments_analyzed=detailed.segments_analyzed,
            )
        detailed.used_reflection = True
        return detailed
