"""Offline chat CLI: ``python -m videollamb_torch.serve.cli --model-path ... --video-file ...``.

Port of ``videollamb_tpu/serve/cli.py`` (reference llava/serve/cli.py:25-111):
load the model, preprocess one video (``--video-file``) or image
(``--image-file``, through the ``--image-tower`` when one is given, else the
video tower at one frame), then answer questions read from stdin until an
empty line or EOF. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(args) -> None:
    from videollamb_torch.constants import DEFAULT_X_TOKEN
    from videollamb_torch.data.video_reader import load_video
    from videollamb_torch.models.builder import load_pretrained_model, resolve_device
    from videollamb_torch.serve.chat import Chat

    device = resolve_device(args.device)
    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, video_tower_path=args.video_tower,
        image_tower_path=args.image_tower,
        dtype="float32" if args.fp32 else "bfloat16", device=device,
        device_preprocess=args.device_preprocess)
    conv_mode = "mistral_instruct" if "mistral" in args.model_path.lower() else "llava_v1"
    if args.conv_mode and args.conv_mode != conv_mode:
        print(f"[WARNING] auto conv mode {conv_mode}, using {args.conv_mode}")
        conv_mode = args.conv_mode
    chat = Chat(tokenizer, model, cfg, processors, conv_mode=conv_mode)

    speculative = None
    draft_params = None
    if args.speculative == "lookup":
        speculative = "lookup"
    elif args.speculative == "self-draft-int8":
        # An int8 copy of the loaded LM drafts for the target (both share the
        # multimodal embeds); greedy-exact, fewer passes of the target.
        import copy

        from videollamb_torch.models.lm.quant import quantize_llama_params

        speculative = "draft"
        draft_params = quantize_llama_params(copy.deepcopy(model.lm))
    frames = images = None
    if args.video_file:
        frames = processors["VIDEO"](load_video(args.video_file, num_frames=args.num_frames))
    elif args.image_file:
        from PIL import Image

        images = processors["IMAGE"](Image.open(args.image_file).convert("RGB"))
    session = None
    if args.kv_reuse and frames is not None and args.temperature == 0:
        from videollamb_torch.serve.chat import KVChatSession

        session = KVChatSession(chat, max_new_tokens=args.max_new_tokens)

    first = True
    while True:
        try:
            inp = input(f"{chat.conv.roles[0]}: ")
        except EOFError:
            break
        if not inp:
            break
        print(f"{chat.conv.roles[1]}: ", end="", flush=True)
        if session is not None:
            out = session.ask(inp, frames if first else None)
        elif frames is not None:
            out = chat.ask_about_video(
                inp, frames, first_turn=first, temperature=args.temperature,
                max_new_tokens=args.max_new_tokens, do_sample=args.temperature > 0,
                speculative=speculative if args.temperature == 0 else None,
                draft_params=draft_params)
        else:
            q = (DEFAULT_X_TOKEN["IMAGE"] + "\n" + inp) if first else inp
            chat.conv.append_message(chat.conv.roles[0], q)
            chat.conv.append_message(chat.conv.roles[1], None)
            out = chat.generate_text(
                chat.conv.get_prompt(), images=images, temperature=args.temperature,
                max_new_tokens=args.max_new_tokens, do_sample=args.temperature > 0)
            chat.conv.messages[-1][1] = out
        print(out)
        first = False
        if args.debug:
            print({"prompt": chat.conv.get_prompt(), "outputs": out})


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--video-tower", type=str, default=None)
    parser.add_argument("--image-tower", type=str, default=None)
    parser.add_argument("--video-file", type=str, default=None)
    parser.add_argument("--image-file", type=str, default=None)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch versions of the kernels)")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="resize / crop / normalise the frames on the device "
                             "(data/device_preprocess.py)")
    parser.add_argument("--kv-reuse", action="store_true",
                        help="multi-turn KV reuse (greedy video chat, used when "
                             "--temperature 0): later turns extend the cache instead "
                             "of re-encoding and re-prefilling")
    parser.add_argument("--speculative", type=str, default=None,
                        choices=["lookup", "self-draft-int8"],
                        help="greedy-exact speculative decoding (used when "
                             "--temperature 0): prompt lookup, or an int8 copy of "
                             "the LM drafting for the loaded one")
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
