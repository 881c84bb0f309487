"""Mixed-modality QA inference: image + video (+ audio) blocks in one prompt.

Port of ``videollamb_tpu/eval/videoqa_mixed.py`` (the reference multi-X
request protocol, llava/eval/model_videoqa_act.py:82-88,117-120: an ``X``
feature list with an ``X_modalities`` list per request, each tag spliced in
order). Each ground-truth question row may name any subset of
{"video_name", "image_name", "audio_name"}; all named media join one prompt
through ``Chat.ask_mixed`` (the K-sentinel splice), and the model answers
free-form for GPT-judge scoring (the output protocol of ``eval/videoqa.py``).
"""

from __future__ import annotations

import argparse
import json
import os

from videollamb_torch.eval.videoqa_mc import (
    add_common_args,
    load_chat,
    load_pairs,
    resolve_video_path,
)


def _load_media(args, sample, chat):
    """The ordered (modality, processed pixels) blocks of a sample; None
    (skip the sample) when a named medium is missing or unreadable."""
    from videollamb_torch.data.media import load_media_blocks

    video_path = (resolve_video_path(args.video_dir, sample["video_name"])
                  if sample.get("video_name") else None)
    if sample.get("video_name") and video_path is None:
        return None
    paths = {
        "VIDEO": video_path,
        "IMAGE": (os.path.join(args.image_dir or args.video_dir, sample["image_name"])
                  if sample.get("image_name") else None),
        "AUDIO": (os.path.join(args.audio_dir or args.video_dir, sample["audio_name"])
                  if sample.get("audio_name") else None),
    }
    blocks = load_media_blocks(paths, chat.processors, num_frames=args.num_frames,
                               strict=False)
    return blocks or None


def run_inference(args, chat=None):
    if chat is None:
        chat = load_chat(args)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    n = 0
    with open(out_path, "w") as ans_file:
        for sample, gt in load_pairs(args):
            blocks = _load_media(args, sample, chat)
            if blocks is None:
                continue
            chat.reset()
            record = {
                "id": sample.get("question_id"),
                "question": sample["question"],
                "answer": gt["answer"],
                "modalities": [m for m, _ in blocks],
                "pred": chat.ask_mixed(
                    sample["question"], blocks, max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, do_sample=args.temperature > 0,
                ),
            }
            n += 1
            ans_file.write(json.dumps(record) + "\n")
    return {"output": out_path, "n": n}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--image_dir", default=None)
    parser.add_argument("--audio_dir", default=None)
    parser.add_argument("--gt_file_question", required=True)
    parser.add_argument("--gt_file_answers", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    run_inference(parse_args())
