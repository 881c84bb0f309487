"""Consistency eval: two paraphrased questions per video, shared answer.

Port of ``videollamb_tpu/eval/videoqa_consistency.py`` (reference
llava/eval/model_videoqa_consistency.py:120-180): answers Q1 and Q2
independently; the consistency GPT judge (``eval/gpt_judge.py``
``--dimension consistency``) scores pred1 vs pred2 vs the common answer.
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


def run_inference(args, chat=None):
    from videollamb_torch.data.video_reader import load_video

    if chat is None:
        chat = load_chat(args)
    with open(args.gt_file) as f:
        samples = get_chunk(json.load(f), args.num_chunks, args.chunk_idx)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    n = 0
    with open(out_path, "w") as ans_file:
        for sample in samples:
            q1, q2 = sample["Q1"], sample["Q2"]
            record = {"id": sample.get("question_id"), "question": q1,
                      "question2": q2, "answer": sample.get("A")}
            video_path = resolve_video_path(args.video_dir, sample["video_name"])
            if video_path is None:
                continue
            raw = load_video(video_path, num_frames=args.num_frames)
            frames = chat.processors["VIDEO"](raw)
            preds = []
            for q in (q1, q2):
                chat.reset()
                preds.append(chat.ask_about_video(
                    q, frames, max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, do_sample=args.temperature > 0,
                ))
            record["pred1"], record["pred2"] = preds
            n += 1
            ans_file.write(json.dumps(record) + "\n")
    return {"output": out_path, "n": n}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--gt_file", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.2)
    return parser.parse_args(argv)


if __name__ == "__main__":
    print(run_inference(parse_args()))
