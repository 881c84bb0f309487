"""Multiple-choice video QA inference (EgoSchema / NExT-QA / EgoPlan /
MVBench).

Port of ``videollamb_tpu/eval/videoqa_mc.py`` (reference
llava/eval/model_videoqa_mc.py:53-253, model_videoqa_mvbench.py): the LLaVA
option-letter prompt, chunked sharding over processes, JSONL output with
running accuracy. Sharding uses chunk-index arguments exactly like the
reference shell launchers (scripts/eval/egoschema.sh:21-48), so the same
merge protocol applies (``eval/acc.py``). The model runs on the card unless
``--device cpu`` is given.

    python -m videollamb_torch.eval.videoqa_mc --model-path <ckpt> \\
        --video-tower <tower> --video_dir <dir> --gt_file_question q.json \\
        --gt_file_answers a.json --output_dir out --output_name pred_1_0 \\
        --num_chunks 1 --chunk_idx 0 --num_frames 8 --names_have_extension \\
        [--batch_slots 4 [--constrained]] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, List, Optional

OPTIONS = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J"]
VIDEO_FORMATS = [".mp4", ".avi", ".mov", ".mkv"]


def split_list(lst: List, n: int) -> List[List]:
    """Split into n (roughly) equal chunks (reference mc eval get_chunk)."""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i: i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst: List, n: int, k: int) -> List:
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


def build_mc_question(question: str, options: Dict[str, str]) -> str:
    """The LLaVA MC prompt (reference model_videoqa_mc.py:201-207)."""
    out = question + "\n"
    for i, op in enumerate(options.values()):
        out += f"{OPTIONS[i]}. {op}\n"
    out += "Answer with the option's letter from the given choices directly."
    return out


def resolve_video_path(video_dir: str, video_name: str,
                       has_extension: bool = False) -> Optional[str]:
    """MVBench names include the extension (reference
    model_videoqa_mvbench.py:223-242); others probe formats."""
    if has_extension:
        p = os.path.join(video_dir, video_name)
        return p if os.path.exists(p) else None
    for fmt in VIDEO_FORMATS:
        p = os.path.join(video_dir, f"{video_name}{fmt}")
        if os.path.exists(p):
            return p
    if os.path.isdir(os.path.join(video_dir, video_name)):
        return os.path.join(video_dir, video_name)
    return None


def load_chat(args):
    """The eval scripts' ``Chat`` over ``--model-path`` / ``--video-tower``, on
    ``--device`` (default the card)."""
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.serve.chat import Chat

    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, video_tower_path=args.video_tower,
        device=args.device)
    return Chat(tokenizer, model, cfg, processors)


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The model, device and sharding flags every eval script takes."""
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--video-tower", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--num_chunks", type=int, default=1)
    parser.add_argument("--chunk_idx", type=int, default=0)


def load_pairs(args) -> List:
    """This shard's (question, answer) pairs of the two ground-truth files."""
    with open(args.gt_file_question) as f:
        gt_questions = json.load(f)
    with open(args.gt_file_answers) as f:
        gt_answers = json.load(f)
    return get_chunk(list(zip(gt_questions, gt_answers)), args.num_chunks, args.chunk_idx)


def run_inference(args, chat=None) -> Dict[str, Any]:
    """Shard-local MC inference -> JSONL. ``chat`` injectable for tests."""
    from videollamb_torch.data.video_reader import load_video

    if chat is None:
        chat = load_chat(args)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    acc, total = 0, 0
    with open(out_path, "w") as ans_file:
        for sample, gt in load_pairs(args):
            question = build_mc_question(sample["question"], sample["option"])
            answer = OPTIONS[gt["answer"]]
            record = {"id": sample["question_id"], "question": question,
                      "answer": answer}
            if "type" in gt:
                record["type"] = gt["type"]

            video_path = resolve_video_path(
                args.video_dir, sample["video_name"],
                has_extension=args.names_have_extension,
            )
            if video_path is None:
                continue
            raw = load_video(video_path, num_frames=args.num_frames)
            frames = chat.processors["VIDEO"](raw)
            chat.reset()
            output = chat.ask_about_video(
                question, frames, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, do_sample=args.temperature > 0,
            )
            pred = output.split(".")[0]
            record["pred"] = pred
            total += 1
            acc += int(pred == answer)
            ans_file.write(json.dumps(record) + "\n")
    return {"output": out_path, "n": total, "acc": acc / max(total, 1)}


def run_inference_batched(args, chat=None, num_slots: int = 4,
                          sync_every: int = 8) -> Dict[str, Any]:
    """MC inference through the dense continuous-batching engine:
    ``num_slots`` questions decode concurrently, submitted in waves of
    2 x slots so at most two waves of video tensors are resident. Per-request
    temperature rides the engine's per-slot sampler, so sampled eval (the
    reference's T=0.2 protocol) works batched too. With ``args.constrained``
    decoding is pinned to the option letters."""
    import torch

    from videollamb_torch.constants import DEFAULT_X_TOKEN
    from videollamb_torch.data.video_reader import load_video
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.chat import media_batch
    from videollamb_torch.serve.server import Request, ServingEngine

    if chat is None:
        chat = load_chat(args)
    engine = ServingEngine(chat.model, chat.cfg, num_slots=num_slots,
                           eos_token_id=int(chat.tokenizer.eos_token_id or 2))
    pairs = load_pairs(args)

    def make_request(uid, sample):
        video_path = resolve_video_path(
            args.video_dir, sample["video_name"],
            has_extension=args.names_have_extension)
        if video_path is None:
            return None
        raw = load_video(video_path, num_frames=args.num_frames)
        frames = chat.processors["VIDEO"](raw)
        question = build_mc_question(sample["question"], sample["option"])
        chat.reset()
        chat.conv.append_message(
            chat.conv.roles[0], DEFAULT_X_TOKEN["VIDEO"] + "\n" + question)
        chat.conv.append_message(chat.conv.roles[1], None)
        ids, mask = chat._prepare_ids(chat.conv.get_prompt(), "VIDEO")
        batch = MultimodalBatch(
            input_ids=torch.from_numpy(ids).to(chat.device),
            attention_mask=torch.from_numpy(mask).to(chat.device),
            videos=media_batch(frames, chat.device, chat.dtype))
        choices = None
        if getattr(args, "constrained", False):
            # The model cannot leave the option-letter set, so no answer is
            # lost to format drift (the reference string-matches free text
            # and scores off-format answers wrong, model_videoqa_mc.py:241-253).
            from videollamb_torch.serve.constrained import tokenize_choice

            letters = OPTIONS[: len(sample["option"])]
            choices = [tokenize_choice(chat.tokenizer, letter) for letter in letters]
        return Request(uid=uid, batch=batch, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature, choices=choices), question

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    acc, total = 0, 0
    stopper_str = chat.stop_str()
    with open(out_path, "w") as ans_file:
        wave = 2 * num_slots
        for start in range(0, len(pairs), wave):
            records = {}
            reqs = []
            for uid, (sample, gt) in enumerate(pairs[start: start + wave], start=start):
                built = make_request(uid, sample)
                if built is None:
                    continue
                req, question = built
                rec = {"id": sample["question_id"], "question": question,
                       "answer": OPTIONS[gt["answer"]]}
                if "type" in gt:
                    rec["type"] = gt["type"]
                records[uid] = rec
                reqs.append(req)
                engine.submit(req)
            engine.run_until_drained(k=sync_every)
            for req in reqs:
                text = chat.tokenizer.decode(req.tokens, skip_special_tokens=True).strip()
                if stopper_str and stopper_str in text:
                    text = text.split(stopper_str)[0].strip()
                pred = text.split(".")[0]
                rec = records[req.uid]
                rec["pred"] = pred
                total += 1
                acc += int(pred == rec["answer"])
                ans_file.write(json.dumps(rec) + "\n")
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
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--names_have_extension", action="store_true")
    parser.add_argument("--constrained", action="store_true",
                        help="constrain decoding to the option letters "
                             "(batched engine path only)")
    parser.add_argument("--batch_slots", type=int, default=0,
                        help=">0: run through the continuous-batching "
                             "engine with this many concurrent questions")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    if _args.batch_slots > 0:
        print(run_inference_batched(_args, num_slots=_args.batch_slots))
    else:
        print(run_inference(_args))
