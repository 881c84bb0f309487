"""MovieChat evaluation: flat QA mode and global / breakpoint mode.

Port of ``videollamb_tpu/eval/videoqa_moviechat.py`` (reference
llava/eval/model_videoqa_moviechat.py: flat QA with the '\\n Answer the
question using several words or phrase.' suffix; model_videoqa_moviechat_ws.py
:144-181: per-video 'global' and 'breakpoint' question sets, answers
written back into the sample structure keyed by '<video>.mp4', merged by
``eval/acc.py --gather-moviechat``).
"""

from __future__ import annotations

import argparse
import json
import os

from videollamb_torch.eval.videoqa_mc import (
    add_common_args,
    get_chunk,
    load_chat,
    resolve_video_path,
)

ANSWER_SUFFIX = "\n Answer the question using several words or phrase."


def _answer(chat, args, video_path: str, question: str) -> str:
    from videollamb_torch.data.video_reader import load_video

    raw = load_video(video_path, num_frames=args.num_frames)
    frames = chat.processors["VIDEO"](raw)
    chat.reset()
    return chat.ask_about_video(
        question, frames, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, do_sample=args.temperature > 0,
    )


def _load_chunk(path: str, args):
    with open(path) as f:
        return get_chunk(json.load(f), args.num_chunks, args.chunk_idx)


def run_inference(args, chat=None):
    """Flat MovieChat QA (reference model_videoqa_moviechat.py:108-180)."""
    if chat is None:
        chat = load_chat(args)
    gt_questions = _load_chunk(args.gt_file_question, args)
    gt_answers = _load_chunk(args.gt_file_answers, args)

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    n = 0
    with open(out_path, "w") as ans_file:
        for sample, gt in zip(gt_questions, gt_answers):
            question = sample["question"] + ANSWER_SUFFIX
            record = {"id": sample["question_id"], "question": question,
                      "answer": gt["answer"], "type": sample.get("type")}
            video_path = resolve_video_path(args.video_dir, sample["video_name"])
            if video_path is None:
                continue
            record["pred"] = _answer(chat, args, video_path, question)
            n += 1
            ans_file.write(json.dumps(record) + "\n")
    return {"output": out_path, "n": n}


def run_inference_global_breakpoint(args, chat=None):
    """Global / breakpoint mode (reference model_videoqa_moviechat_ws.py)."""
    if chat is None:
        chat = load_chat(args)
    gt = _load_chunk(args.gt_file_question, args)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    with open(out_path, "w") as ans_file:
        for samples in gt:
            key_video_name = samples["video_name"]
            for section in ("global", "breakpoint"):
                for sample in samples.get(section, []):
                    video_path = os.path.join(args.video_dir, f"{sample['video_name']}.mp4")
                    if not os.path.exists(video_path):
                        continue
                    sample["answer"] = _answer(chat, args, video_path, sample["question"])
            ans_file.write(json.dumps({
                f"{key_video_name}.mp4": {
                    "global": samples.get("global", []),
                    "breakpoint": samples.get("breakpoint", []),
                }
            }) + "\n")
    return {"output": out_path}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--gt_file_question", required=True)
    parser.add_argument("--gt_file_answers", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--mode", choices=["flat", "global_breakpoint"], default="flat")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    if args.mode == "flat":
        print(run_inference(args))
    else:
        print(run_inference_global_breakpoint(args))
