"""Bench config #5 (bench.py) through the port: end-to-end QA accuracy +
throughput over a ground-truthed synthetic store (the counterpart of
scripts/qa_accuracy.py, which imports jax).

Usage:
  python -m hippomm_tpu_torch.benchmarks.qa_accuracy [--duration 3600] [--videos 3]
      [--questions 60] [--variant tiny|huge] [--container mp4|y4m] [--cpu]

Prints one JSON line: {"qa_accuracy": ..., "ci95": [lo, hi],
"accuracy_by_type": {...}, "ingest_x": ..., "recall_p50_ms": ...}, and one
OK/MISS line per question on stderr. Runs on CUDA unless --cpu is given.
"""

import argparse
import json
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=3600.0,
                    help="seconds PER VIDEO")
    ap.add_argument("--questions", type=int, default=60)
    ap.add_argument("--videos", type=int, default=3)
    ap.add_argument("--variant", default="tiny", choices=("tiny", "huge"))
    ap.add_argument("--scene-seconds", type=float, default=30.0)
    ap.add_argument("--no-negatives", action="store_true")
    ap.add_argument("--caption-noise", type=float, default=0.0,
                    help="per-caption probability the oracle VLM confuses the "
                         "color with its nearest corpus neighbor (difficulty "
                         "knob — see hippomm_tpu_torch/benchmarks/README.md)")
    ap.add_argument("--distractors", action="store_true",
                    help="last video reuses video 0's colors (near-duplicate "
                         "distractor scenes; unique tones)")
    ap.add_argument("--container", default="mp4", choices=("mp4", "y4m"),
                    help="corpus files: H.264 + AAC mp4 (needs the libav shim) or "
                         "Y4M with a sibling 16 kHz WAV")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    args = ap.parse_args(argv)

    from hippomm_tpu_torch.benchmarks.qa_harness import run_harness

    with tempfile.TemporaryDirectory(prefix="hippomm_qa_") as work:
        out = run_harness(
            work,
            duration=args.duration,
            scene_seconds=args.scene_seconds,
            n_questions=args.questions,
            imagebind_variant=args.variant,
            n_videos=args.videos,
            negatives=not args.no_negatives,
            caption_noise=args.caption_noise,
            distractors=args.distractors,
            device="cpu" if args.cpu else None,
            container=args.container,
        )
    detail = out.pop("results")
    for r in detail:
        print(("OK " if r["correct"] else "MISS ")
              + f"[{r['type']}] " + r["q"] + " -> " + r["answer"],
              file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
