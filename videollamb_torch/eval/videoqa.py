"""Open-ended video QA inference (MSVD / MSRVTT / ActivityNet style).

Port of ``videollamb_tpu/eval/videoqa.py`` (reference
llava/eval/model_videoqa.py:51-185 and its _general / _act variants):
free-form answers to JSONL for GPT-judge scoring (``eval/gpt_judge.py``).
"""

from __future__ import annotations

import argparse
import json
import os

from videollamb_torch.eval.videoqa_mc import (
    load_pairs,
    add_common_args,
    load_chat,
    resolve_video_path,
)


def run_inference(args, chat=None):
    from videollamb_torch.data.video_reader import load_video

    if chat is None:
        chat = load_chat(args)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    n = 0
    with open(out_path, "w") as ans_file:
        for sample, gt in load_pairs(args):
            question = sample["question"]
            record = {
                "id": sample.get("question_id"),
                "question": question,
                "answer": gt["answer"],
            }
            video_path = resolve_video_path(args.video_dir, sample["video_name"])
            if video_path is None:
                continue
            raw = load_video(video_path, num_frames=args.num_frames)
            frames = chat.processors["VIDEO"](raw)
            chat.reset()
            record["pred"] = chat.ask_about_video(
                question, frames, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, do_sample=args.temperature > 0,
            )
            n += 1
            ans_file.write(json.dumps(record) + "\n")
    return {"output": out_path, "n": n}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--gt_file_question", required=True)
    parser.add_argument("--gt_file_answers", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.2)
    return parser.parse_args(argv)


if __name__ == "__main__":
    print(run_inference(parse_args()))
