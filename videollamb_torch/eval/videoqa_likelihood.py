"""Likelihood-ranked multiple-choice QA: argmin per-option answer loss.

Port of ``videollamb_tpu/eval/videoqa_likelihood.py`` (reference
llava/eval/model_videoqa_act.py:55-160): for each option, build the v1
conversation with the option as the assistant answer, run one multimodal
forward with the same video for every row, and pick the option with the
lowest mean cross-entropy over its (masked) answer tokens. The n option
rows go through ``videollamb_forward`` as one batch; on the card its
attention is kernel K3 at (n, heads, S, head_dim), causal, with each row's
own key mask.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np
import torch

from videollamb_torch.constants import DEFAULT_X_TOKEN, IGNORE_INDEX
from videollamb_torch.eval.videoqa_mc import (
    OPTIONS,
    add_common_args,
    load_chat,
    load_pairs,
    resolve_video_path,
)
from videollamb_torch.models.assembly import MultimodalBatch, videollamb_forward
from videollamb_torch.train.preprocess import preprocess


@torch.no_grad()
def option_losses(chat, question: str, options: Sequence[str], frames) -> torch.Tensor:
    """Mean cross-entropy of each option's answer tokens (reference :89-158),
    (n,) f32 on the model's device."""
    sources = [
        [{"from": "human", "value": DEFAULT_X_TOKEN["VIDEO"] + "\n" + question},
         {"from": "gpt", "value": option}]
        for option in options
    ]
    per_option = [preprocess([s], chat.tokenizer, x="VIDEO") for s in sources]
    max_len = max(len(d["input_ids"][0]) for d in per_option)
    max_len = min(-(-max_len // 16) * 16, chat.cfg.max_length)

    n = len(options)
    pad_id = int(chat.tokenizer.pad_token_id or 0)
    ids = np.full((n, max_len), pad_id, np.int64)
    labels = np.full((n, max_len), IGNORE_INDEX, np.int64)
    mask = np.zeros((n, max_len), np.int64)
    for i, d in enumerate(per_option):
        row = d["input_ids"][0][:max_len]
        ids[i, : len(row)] = row
        labels[i, : len(row)] = d["labels"][0][:max_len]
        mask[i, : len(row)] = 1

    dev = chat.device
    videos = torch.as_tensor(frames).to(dev, chat.dtype)[None].expand(n, *frames.shape)
    batch = MultimodalBatch(input_ids=torch.from_numpy(ids).to(dev),
                            attention_mask=torch.from_numpy(mask).to(dev),
                            labels=torch.from_numpy(labels).to(dev), videos=videos)
    logits, spliced = videollamb_forward(chat.model, chat.cfg, batch)

    shift_logits = logits[:, :-1].float()
    shift_labels = spliced.labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    tok_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -torch.where(valid, tok_logp, 0.0).sum(1) / valid.sum(1).clamp(min=1)


def rank_options_by_likelihood(chat, question: str, options: Sequence[str], frames) -> int:
    """The argmin-loss option index (reference :89-158)."""
    return int(torch.argmin(option_losses(chat, question, options, frames)))


def run_inference(args, chat=None):
    from videollamb_torch.data.video_reader import load_video

    if chat is None:
        chat = load_chat(args)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    acc, total = 0, 0
    with open(out_path, "w") as ans_file:
        for sample, gt in load_pairs(args):
            options = list(sample["option"].values())
            answer = OPTIONS[gt["answer"]]
            video_path = resolve_video_path(args.video_dir, sample["video_name"])
            if video_path is None:
                continue
            raw = load_video(video_path, num_frames=args.num_frames)
            frames = chat.processors["VIDEO"](raw)
            idx = rank_options_by_likelihood(chat, sample["question"], options, frames)
            pred = chr(ord("A") + idx)
            total += 1
            acc += int(pred == answer)
            ans_file.write(json.dumps({
                "id": sample["question_id"], "question": sample["question"],
                "answer": answer, "pred": pred,
                **({"type": gt["type"]} if "type" in gt else {}),
            }) + "\n")
    return {"output": out_path, "n": total, "acc": acc / max(total, 1)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--gt_file_question", required=True)
    parser.add_argument("--gt_file_answers", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num_frames", type=int, default=8)
    return parser.parse_args(argv)


if __name__ == "__main__":
    print(run_inference(parse_args()))
