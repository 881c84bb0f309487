"""Gradio web demo (counterpart of llava/serve/gradio_demo.py:33-252 +
gradio_utils.py:51-120).

Port of ``videollamb_tpu/serve/gradio_demo.py``; it runs on the card unless
``--device cpu`` is given.

Feature parity with the reference demo: image AND video inputs, a chatbot
with conversation state, streamer-based incremental output
(Chat.stream_text — the reference uses TextIteratorStreamer), regenerate /
clear controls, and temperature / top-p / max-tokens sliders.

Import-gated: gradio is an optional dependency; the module raises a clear
error at launch time when it is missing.
"""

from __future__ import annotations

import argparse

TITLE = "VideoLLaMB"
DESCRIPTION = (
    "Long-video understanding with the recurrent Memory Bridge. Upload a "
    "video or image and chat about it."
)


def build_demo(chat):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is required for the web demo: pip install gradio"
        ) from e

    import numpy as np

    from videollamb_torch.constants import DEFAULT_X_TOKEN
    from videollamb_torch.data.video_reader import load_video

    def load_media(video_file, image_file):
        """-> (frames, image, status). Video wins when both are given
        (reference generate(), gradio_demo.py:33-70)."""
        chat.reset()
        if video_file:
            raw = load_video(video_file, num_frames=16)
            return (chat.processors["VIDEO"](raw), None,
                    f"Loaded {raw.shape[0]} video frames.", True)
        if image_file:
            img = (np.asarray(image_file.convert("RGB")) if hasattr(image_file, "convert")
                   else np.asarray(image_file))
            return (None, chat.processors["IMAGE"](img), "Loaded image.", True)
        return None, None, "Upload a video or an image first.", True

    def stream_reply(message, history, media, temperature, top_p, max_tokens):
        frames, image, first = media["frames"], media["image"], media["first"]
        if frames is None and image is None:
            yield history + [[message, "Please upload a video or image first."]]
            return
        token = DEFAULT_X_TOKEN["VIDEO" if frames is not None else "IMAGE"]
        question = (token + "\n" + message) if first else message
        chat.conv.append_message(chat.conv.roles[0], question)
        chat.conv.append_message(chat.conv.roles[1], None)
        prompt = chat.conv.get_prompt()
        partial = ""
        for partial in chat.stream_text(
            prompt,
            videos=frames if frames is not None else None,
            images=image if image is not None else None,
            max_new_tokens=int(max_tokens),
            temperature=float(temperature),
            do_sample=float(temperature) > 0,
        ):
            yield history + [[message, partial]]
        chat.conv.messages[-1][1] = partial
        media["first"] = False
        yield history + [[message, partial]]

    def user_submit(message, history):
        return "", history

    def regenerate(history, media, temperature, top_p, max_tokens):
        """Drop the last exchange and re-ask (reference regenerate(),
        gradio_demo.py:112-118)."""
        if not history:
            yield history
            return
        message, _ = history[-1]
        history = history[:-1]
        if chat.conv.messages:
            chat.conv.messages = chat.conv.messages[:-2]
        yield from stream_reply(message, history, media, temperature, top_p, max_tokens)

    def clear_history(media):
        chat.reset()
        media["first"] = True
        return [], "Cleared."

    with gr.Blocks(title=TITLE) as demo:
        gr.Markdown(f"# {TITLE}\n{DESCRIPTION}")
        media = gr.State({"frames": None, "image": None, "first": True})
        with gr.Row():
            with gr.Column(scale=3):
                video = gr.Video(label="Input Video")
                image = gr.Image(label="Input Image", type="pil")
                status = gr.Textbox(label="status", interactive=False)
                with gr.Accordion("Parameters", open=False):
                    temperature = gr.Slider(0.0, 1.0, value=0.2, step=0.05,
                                            label="Temperature")
                    top_p = gr.Slider(0.0, 1.0, value=0.7, step=0.05, label="Top P")
                    max_tokens = gr.Slider(32, 1024, value=512, step=32,
                                           label="Max output tokens")
            with gr.Column(scale=7):
                chatbot = gr.Chatbot(label="VideoLLaMB", height=520)
                textbox = gr.Textbox(show_label=False,
                                     placeholder="Enter text and press ENTER")
                with gr.Row():
                    submit_btn = gr.Button("Send", variant="primary")
                    regen_btn = gr.Button("🔄 Regenerate")
                    clear_btn = gr.Button("🗑️ Clear history")

        def on_media(video_file, image_file, media):
            frames, img, msg, first = load_media(video_file, image_file)
            media.update(frames=frames, image=img, first=first)
            return msg, media

        video.change(on_media, [video, image, media], [status, media])
        image.change(on_media, [video, image, media], [status, media])
        submit_args = dict(
            fn=stream_reply,
            inputs=[textbox, chatbot, media, temperature, top_p, max_tokens],
            outputs=[chatbot],
        )
        textbox.submit(**submit_args).then(lambda: "", None, [textbox])
        submit_btn.click(**submit_args).then(lambda: "", None, [textbox])
        regen_btn.click(regenerate,
                        [chatbot, media, temperature, top_p, max_tokens],
                        [chatbot])
        clear_btn.click(clear_history, [media], [chatbot, status])
    return demo


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--model-base", default=None)
    parser.add_argument("--video-tower", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="resize / crop / normalise the frames on the device")
    args = parser.parse_args(argv)

    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.serve.chat import Chat

    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, video_tower_path=args.video_tower,
        device_preprocess=args.device_preprocess, device=args.device)
    chat = Chat(tokenizer, model, cfg, processors)
    demo = build_demo(chat)
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
