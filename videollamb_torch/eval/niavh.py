"""Needle In A Video Haystack (NIAVH) pressure test.

Port of ``videollamb_tpu/eval/niavh.py`` (its numpy helpers copied); the
model runs on the card unless ``--device cpu`` is given. The reference README points its users at the MM-NIAVH companion
benchmark ("check our benchmark Needle In A Video Haystack",
reference README.md:144-149) and ships a dedicated model for it
(VideoLLaMB-7B-Mem, README.md:158) — the long-video memory stress test
is the Memory Bridge's raison d'être. The companion repo is external,
so this script is self-contained: it synthesizes the haystack protocol
(insert a short needle clip at depth ``d`` of an ``L``-frame haystack,
ask the needle question, score by answer-substring match) and emits the
standard depth x length accuracy grid.

Two inference routes, same protocol:
- ``--mode full``: the whole assembled video through ``Chat`` (the
  offline eval path every other eval script here uses);
- ``--mode streaming``: frames fed one tick at a time through
  ``serve/incremental.StreamingSession`` and the question asked at the end —
  this is the pressure test the bridge memory + context compaction are
  FOR (pre-compaction needles must survive via the recurrent memory).

Outputs one JSONL of per-cell records plus a summary JSON:
``{"grid": {length: {depth: accuracy}}, "overall": acc, "n": N}``.
Raw records keep question/answer/pred so the GPT-judge pipeline
(``eval/gpt_judge.py``) can rescore free-form answers.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np


def sample_indices(total: int, want: int) -> np.ndarray:
    """Uniform (linspace) frame sample — same policy as the video loader."""
    if total <= want:
        return np.arange(total)
    return np.linspace(0, total - 1, want).round().astype(np.int64)


def insert_needle(
    haystack: np.ndarray,  # (T_h, H, W, 3) uint8
    needle: np.ndarray,    # (T_n, H, W, 3) uint8
    length: int,           # total frames of the assembled video
    depth: float,          # 0.0 = start .. 1.0 = end
) -> tuple[np.ndarray, int]:
    """Assemble an exactly ``length``-frame video: the haystack uniformly
    subsampled to ``length - T_n`` frames with the full needle clip
    inserted at ``round(depth * (length - T_n))``. Returns (frames,
    needle_start_index). Needle frames are resized to the haystack frame
    geometry if they differ (nearest-neighbor index map — no cv2 dep)."""
    t_n = len(needle)
    if t_n >= length:
        raise ValueError(f"needle ({t_n} frames) must be shorter than the "
                         f"assembled length ({length})")
    body = haystack[sample_indices(len(haystack), length - t_n)]
    if needle.shape[1:3] != body.shape[1:3]:
        hi = np.linspace(0, needle.shape[1] - 1, body.shape[1]).round().astype(int)
        wi = np.linspace(0, needle.shape[2] - 1, body.shape[2]).round().astype(int)
        needle = needle[:, hi][:, :, wi]
    start = int(round(depth * len(body)))
    start = max(0, min(start, len(body)))
    out = np.concatenate([body[:start], needle.astype(body.dtype), body[start:]])
    assert len(out) == length
    return out, start


def score_pred(pred: str, answer: str) -> bool:
    """Substring containment, case/punctuation-lenient — the standard
    needle-retrieval criterion; free-form grading can be redone with the
    GPT judge over the saved records. Non-alphanumerics (newlines,
    hyphens, tabs) map to spaces, then runs collapse, so "red\\ncar" and
    "ice-cream" still match "red car" / "ice cream"."""
    def norm(s: str) -> str:
        return " ".join(
            "".join(c if c.isalnum() else " " for c in s.lower()).split())

    return norm(answer) in norm(pred)


def summarize(records: List[dict]) -> dict:
    grid: Dict[int, Dict[float, List[bool]]] = {}
    for r in records:
        grid.setdefault(r["length"], {}).setdefault(r["depth"], []).append(
            bool(r["correct"]))
    out = {
        str(length): {
            str(depth): round(sum(v) / len(v), 4)
            for depth, v in sorted(row.items())
        }
        for length, row in sorted(grid.items())
    }
    n = len(records)
    overall = round(sum(bool(r["correct"]) for r in records) / n, 4) if n else 0.0
    return {"grid": out, "overall": overall, "n": n}


def _ask_full(chat, frames: np.ndarray, question: str, args) -> str:
    processed = chat.processors["VIDEO"](frames)
    chat.reset()
    return chat.ask_about_video(
        question, processed, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, do_sample=args.temperature > 0,
    )


def _ask_streaming(chat, frames: np.ndarray, question: str, args) -> str:
    from videollamb_torch.serve.incremental import StreamingSession

    chat.reset()
    sess = StreamingSession(
        chat, frame_fps=1.0,
        max_open_frames=args.stream_open_frames,
        max_seq_len=args.stream_seq_len,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
    )
    t_total = len(frames)
    sess.video_tensor = chat.processors["VIDEO"](frames)
    sess.num_video_frames = t_total
    sess.video_duration = float(t_total)
    response = None
    asked = False
    for i in range(t_total):
        if i == t_total - 1:
            # Queries are served when a frame with time STRICTLY greater
            # arrives (incremental._call_for_streaming), so timestamp the
            # question just before the final frame: it is answered on the
            # last tick, after every frame (depth-1.0 needles included)
            # has been folded (_call_for_response closes open frames).
            sess.input_query_stream(question, video_time=float(i) - 0.5)
            asked = True
        sess.input_video_stream(float(i))
        q, r = sess()
        if asked and r is not None and "User:" in (q or ""):
            response = r
    return response or ""


def run_pressure_test(args, chat=None) -> dict:
    """Run the grid. ``chat`` may be injected (tests); otherwise built
    from ``--model-path`` exactly like the other eval scripts."""
    from videollamb_torch.data.video_reader import load_video
    from videollamb_torch.eval.videoqa_mc import load_chat

    if chat is None:
        chat = load_chat(args)

    with open(args.needle_json) as f:
        cases = json.load(f)
    lengths = [int(x) for x in str(args.lengths).split(",") if x]
    depths = [float(x) for x in str(args.depths).split(",") if x]
    max_len = max(lengths)

    haystack = load_video(args.haystack_video, num_frames=max_len,
                          max_frames=max(512, max_len))

    ask = _ask_streaming if args.mode == "streaming" else _ask_full
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.jsonl")
    records = []
    with open(out_path, "w") as f:
        for case in cases:
            needle = load_video(case["needle"], num_frames=args.needle_frames)
            for length in lengths:
                for depth in depths:
                    frames, start = insert_needle(haystack, needle, length, depth)
                    pred = ask(chat, frames, case["question"], args)
                    rec = {
                        "needle": case["needle"],
                        "question": case["question"],
                        "answer": case["answer"],
                        "pred": pred,
                        "length": length,
                        "depth": depth,
                        "needle_start": start,
                        "correct": score_pred(pred, case["answer"]),
                    }
                    records.append(rec)
                    f.write(json.dumps(rec) + "\n")
    summary = summarize(records)
    summary["records"] = out_path
    with open(os.path.join(args.output_dir, f"{args.output_name}_grid.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--video-tower", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--haystack_video", required=True,
                        help="long background video the needle hides in")
    parser.add_argument("--needle_json", required=True,
                        help='JSON list of {"needle": path, "question": q,'
                             ' "answer": a} cases')
    parser.add_argument("--lengths", default="32,64,128,256",
                        help="comma list of assembled context lengths (frames)")
    parser.add_argument("--depths", default="0.0,0.25,0.5,0.75,1.0",
                        help="comma list of needle depth fractions")
    parser.add_argument("--needle_frames", type=int, default=4,
                        help="frames sampled from each needle clip")
    parser.add_argument("--mode", choices=("full", "streaming"), default="full")
    parser.add_argument("--stream_open_frames", type=int, default=32)
    parser.add_argument("--stream_seq_len", type=int, default=2048)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", default="niavh")
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--temperature", type=float, default=0.0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    print(json.dumps(run_pressure_test(parse_args())))
