"""Batch serving CLI: drive the continuous-batching engines from JSONL.

Port of ``videollamb_tpu/serve/batch_cli.py``:

    python -m videollamb_torch.serve.batch_cli \\
        --model-path <ckpt> --video-tower <tower dir> \\
        --requests in.jsonl --output out.jsonl --paged --quantize-kv --num-slots 8

Each input line: {"id": ..., "prompt": ..., "video": <path, optional>,
"image": <path, optional>, "audio": <WAV path, optional>,
"max_new_tokens": ..., "temperature": ...}, optionally with "system",
"system_suffix", "history" ([[user, assistant], ...]) or "raw" (a text-only
prompt tokenized verbatim), and the request fields of the JAX package's CLI:

- "choices": ["A", "B", ...] pins the output to one of the strings;
- "response_format": "json_object" (output parses as a JSON object),
  {"type": "json_schema", "schema": {...}}, {"type": "regex", "regex": ...}
  or {"type": "tool_call", "schemas": [...]};
- "logit_bias" ({token id: bias}), "presence_penalty", "frequency_penalty",
  "min_tokens", "top_k";
- "logprobs": true and "top_logprobs": N;
- "adapter": the name of a multi-LoRA adapter of the engine;
- "shared_prefix": true (paged engine, rows with media): the system,
  history and media become an automatically cached prefix and only the
  question is prefilled per request (``--prefix-cache-size`` prefixes kept).

A row naming two or three media becomes one mixed-modality request whose
k-th prompt tag binds block k (reference multi-X request assembly,
llava/eval/model_videoqa_act.py:117-120); an audio row's WAV becomes a
log-mel image that rides the image path.

The LM family comes from the checkpoint's config.json: the Llama decoder
(Llama, Vicuna, Mistral) runs on either engine; ``model_type:
deepseek_v3`` (Moonlight-16B-A3B's latent attention and routed experts,
``models/lm/mla.py``) runs with ``--paged`` only, over bf16 (or ``--fp32``)
latent pages, and is refused with ``--quantize-kv`` and ``--load-8bit``.

Each output line: {"id": ..., "text": ..., "tokens": N}, with
"token_logprobs" (and "top_logprobs": [[[id, logprob], ...], ...]) on rows
that asked for logprobs, and "error" on rows the engine dropped. It runs on
the card unless ``--device cpu`` is given; ``--device-preprocess`` resizes
and normalises the frames there too (``data/device_preprocess.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _sampling_controls(row: Dict[str, Any]) -> Dict[str, Any]:
    """The optional sampling-control fields of a row -> Request kwargs."""
    out: Dict[str, Any] = {}
    if row.get("logit_bias"):
        out["logit_bias"] = {int(t): float(b) for t, b in row["logit_bias"].items()}
    for key, cast in (("presence_penalty", float), ("frequency_penalty", float),
                      ("min_tokens", int), ("top_k", int)):
        if row.get(key):
            out[key] = cast(row[key])
    return out


def _constraint_kwargs(row: Dict[str, Any], tokenizer) -> Dict[str, Any]:
    """"choices" -> token-id choices; "response_format" -> a grammar
    cursor (serve/grammar.py, schema.py, regex_grammar.py)."""
    out: Dict[str, Any] = {}
    if row.get("choices"):
        from videollamb_torch.serve.constrained import tokenize_choice

        out["choices"] = [tokenize_choice(tokenizer, c) for c in row["choices"]]
    fmt = row.get("response_format")
    if isinstance(fmt, dict):
        if fmt.get("type") == "tool_call":
            from videollamb_torch.serve.schema import alternation_constraint

            out["grammar"] = alternation_constraint(tokenizer, fmt["schemas"])
        elif fmt.get("type") == "regex":
            from videollamb_torch.serve.regex_grammar import regex_constraint

            out["grammar"] = regex_constraint(tokenizer, fmt["regex"])
        else:
            from videollamb_torch.serve.schema import schema_constraint

            out["grammar"] = schema_constraint(tokenizer, fmt["schema"])
    elif fmt:
        from videollamb_torch.serve.grammar import json_constraint

        out["grammar"] = json_constraint(tokenizer, mode=fmt)
    return out


def build_requests(lines: List[Dict[str, Any]], chat) -> List[Any]:
    """Conversation template + media -> Requests, one fresh conversation per
    row (the reference cli.py prompt assembly)."""
    import numpy as np
    import torch

    from videollamb_torch.constants import DEFAULT_X_TOKEN
    from videollamb_torch.data.media import load_media_blocks
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.server import Request

    def text_batch(ids_list):
        t = max(chat.text_bucket, -(-len(ids_list) // chat.text_bucket) * chat.text_bucket)
        ids = np.zeros((1, t), np.int64)
        mask = np.zeros((1, t), np.int64)
        ids[0, :len(ids_list)] = ids_list
        mask[0, :len(ids_list)] = 1
        return ids, mask

    def batch_of(ids, mask, **media):
        return MultimodalBatch(input_ids=torch.from_numpy(ids).to(chat.device),
                               attention_mask=torch.from_numpy(mask).to(chat.device), **media)

    def request(row, batch, **kw):
        return Request(
            uid=row.get("id"), batch=batch, max_new_tokens=int(row.get("max_new_tokens", 128)),
            temperature=float(row.get("temperature", 0.0)), adapter=row.get("adapter"),
            logprobs=bool(row.get("logprobs")), top_logprobs=int(row.get("top_logprobs", 0)),
            **_constraint_kwargs(row, chat.tokenizer), **_sampling_controls(row), **kw)

    reqs = []
    for row in lines:
        if row.get("raw"):
            if any(row.get(k) for k in ("video", "image", "audio")):
                raise ValueError("'raw' rows are text-only (no template to place media tags in)")
            ids_list = chat.tokenizer(row["prompt"]).input_ids
            reqs.append(request(row, batch_of(*text_batch(ids_list))))
            continue
        # Every medium the row names, in (video, image, audio) order, on the
        # model's device in its dtype.
        media = [(m, torch.as_tensor(px).to(chat.device, chat.dtype))
                 for m, px in load_media_blocks(
                     {"VIDEO": row.get("video"), "IMAGE": row.get("image"),
                      "AUDIO": row.get("audio")}, chat.processors, strict=True)]
        chat.reset()
        if row.get("system") is not None:
            chat.conv.system = row["system"]
        if row.get("system_suffix"):
            chat.conv.system = (chat.conv.system or "") + row["system_suffix"]
        history = row.get("history") or []
        question = row["prompt"]
        # One tag per medium not already placed in the prompt or a prior turn.
        seen = question + "".join(u + (a or "") for u, a in history)
        for modality, _ in reversed(media):
            if DEFAULT_X_TOKEN[modality] not in seen:
                question = DEFAULT_X_TOKEN[modality] + "\n" + question
        for user_msg, assistant_msg in history:
            chat.conv.append_message(chat.conv.roles[0], user_msg)
            chat.conv.append_message(chat.conv.roles[1], assistant_msg)
        chat.conv.append_message(chat.conv.roles[0], question)
        chat.conv.append_message(chat.conv.roles[1], None)
        fields: Dict[str, Any] = {}
        if len(media) >= 2:
            ids, mask, tag_order = chat._prepare_multi_ids(chat.conv.get_prompt())
            by_mod = dict(media)
            if sorted(tag_order) != sorted(by_mod):
                raise ValueError(
                    f"request {row.get('id')!r}: prompt tags {tag_order} do not match the "
                    f"attached media {sorted(by_mod)}: remove stray <image>/<video>/<audio> "
                    "tags or attach the file")
            fields["blocks"] = tuple((m, by_mod[m]) for m in tag_order)
        else:
            modality = media[0][0] if media else None
            ids, mask = chat._prepare_ids(chat.conv.get_prompt(), modality or "IMAGE")
            if modality == "VIDEO":
                fields["videos"] = media[0][1][None]
            elif modality in ("IMAGE", "AUDIO"):
                fields["images"] = media[0][1][None]
        if not row.get("shared_prefix"):
            reqs.append(request(row, batch_of(ids, mask, **fields)))
            continue
        # Automatic prefix caching (paged engine): the token ids split AFTER
        # the last media sentinel. System, history and media become the
        # cached prefix, the question the suffix; splitting the ids (not the
        # prompt string) keeps the prefix's KV independent of the suffix.
        if not media:
            raise ValueError(f"request {row.get('id')!r}: 'shared_prefix' needs attached media "
                             "(the shared part is system + media)")
        valid = int(mask.sum())
        p = int(np.nonzero(ids[0, :valid] < 0)[0][-1]) + 1
        prefix = batch_of(ids[:, :p], np.ones((1, p), np.int64), **fields)
        reqs.append(request(row, batch_of(*text_batch(ids[0, p:valid].tolist())),
                            prefix_batch=prefix))
    return reqs


def serve_requests(engine, requests, tokenizer, k: int = 8):
    for r in requests:
        engine.submit(r)
    done = engine.run_until_drained(k=k)
    out = []
    for r in done:
        text = tokenizer.decode(r.tokens, skip_special_tokens=True)
        row = {"id": r.uid, "text": text.strip(), "tokens": len(r.tokens)}
        if r.logprobs:
            row["token_logprobs"] = r.token_logprobs
            if r.top_logprobs:
                row["top_logprobs"] = [[list(e) for e in pos] for pos in r.top_tokens]
        if r.error:
            row["error"] = r.error
        out.append(row)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve JSONL requests with the continuous-batching engines.",
        epilog="LM families (config.json's model_type): llama / mistral on either engine; "
               "deepseek_v3 (latent attention, routed experts: Moonlight-16B-A3B) with "
               "--paged only, bf16 or --fp32 latent pages, not with --quantize-kv or "
               "--load-8bit.")
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--video-tower", default=None,
                        help="LanguageBind video tower dir (video rows need it)")
    parser.add_argument("--requests", required=True, help="input JSONL")
    parser.add_argument("--output", required=True, help="output JSONL")
    parser.add_argument("--num-slots", type=int, default=4)
    parser.add_argument("--paged", action="store_true",
                        help="paged KV pool (serve/paged.py) instead of dense per-slot rows; "
                             "the only engine of the deepseek_v3 family (latent pages)")
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--quantize-kv", action="store_true",
                        help="int8 KV pages (paged engine, Llama family only)")
    parser.add_argument("--prefix-cache-size", type=int, default=8,
                        help="max automatically cached prompt prefixes (paged engine; "
                             "'shared_prefix' rows)")
    parser.add_argument("--sync-every", type=int, default=8,
                        help="decode steps between host syncs")
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--load-8bit", action="store_true",
                        help="weight-only int8 LM (models/lm/quant.py; Llama family only)")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="resize / crop / normalise the frames on the device "
                             "(data/device_preprocess.py)")
    args = parser.parse_args(argv)
    if args.quantize_kv and not args.paged:
        sys.exit("--quantize-kv needs --paged")

    from videollamb_torch.models.builder import load_pretrained_model, resolve_device
    from videollamb_torch.serve.chat import Chat

    device = resolve_device(args.device)
    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, video_tower_path=args.video_tower,
        dtype="float32" if args.fp32 else "bfloat16", load_8bit=args.load_8bit, device=device,
        device_preprocess=args.device_preprocess)
    chat = Chat(tokenizer, model, cfg, processors)
    eos = int(tokenizer.eos_token_id or 2)
    if args.paged:
        from videollamb_torch.serve.paged import PagedServingEngine

        engine = PagedServingEngine(model, cfg, num_slots=args.num_slots,
                                    page_size=args.page_size, quantize_kv=args.quantize_kv,
                                    eos_token_id=eos, prefix_cache_size=args.prefix_cache_size)
    else:
        from videollamb_torch.serve.server import ServingEngine

        engine = ServingEngine(model, cfg, num_slots=args.num_slots, eos_token_id=eos)

    with open(args.requests) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    out = serve_requests(engine, build_requests(lines, chat), tokenizer, k=args.sync_every)
    with open(args.output, "w") as f:
        for row in out:
            f.write(json.dumps(row) + "\n")
    print(f"served {len(out)} requests -> {args.output}")


if __name__ == "__main__":
    main()
