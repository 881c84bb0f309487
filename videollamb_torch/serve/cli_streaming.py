"""Streaming chat CLI with fps and latency accounting.

    python -m videollamb_torch.serve.cli_streaming --model-path ... \
        --video-tower ... --video-file clip.mp4 --query "what happens" \
        [--incremental] [--no-sleep] [--device cpu]

Port of ``videollamb_tpu/serve/cli_streaming.py`` (reference
llava/serve/cli_streaming.py:29-68): an optional ffmpeg re-encode cache, a
tick per frame at ``--frame-fps`` (paced to real time unless
``--no-sleep``), and the conversation with each turn's time, cost and fps
dumped as JSON. ``--incremental`` runs the carried-state engine
(``serve/incremental.StreamingSession``) in place of ``LiveInfer``. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time


def main(liveinfer, args) -> None:
    liveinfer.load_videos(args.video_file)
    if args.query:
        liveinfer.input_query_stream(args.query, video_time=args.query_time)

    history = {"video_path": args.video_file, "frame_fps": liveinfer.frame_fps,
               "conversation": []}
    timecosts = []
    start_time = time.time()
    frame_interval = 1.0 / liveinfer.frame_fps

    for i in range(liveinfer.num_video_frames):
        video_time = i / liveinfer.frame_fps
        liveinfer.input_video_stream(video_time)
        query, response = liveinfer()
        cost = time.time() - start_time - i * (0 if args.no_sleep else frame_interval)
        timecosts.append(cost)
        fps = (i + 1) / max(sum(timecosts), 1e-6)
        if query or response:
            print(f"[t={video_time:.0f}s cost={cost:.2f}s fps={fps:.1f}]")
        if query:
            print(query)
            history["conversation"].append({"role": "user", "content": query,
                                            "time": video_time, "cost": cost})
        if response:
            print(response)
            history["conversation"].append({"role": "assistant", "content": response,
                                            "time": video_time, "cost": cost, "fps": fps})
        if not args.no_sleep:
            time.sleep(max(0.0, frame_interval - cost))

    with open(args.output, "w") as f:
        json.dump(history, f, indent=2)
    print(f"history -> {args.output}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--video-tower", type=str, default=None)
    parser.add_argument("--video-file", type=str, required=True)
    parser.add_argument("--query", type=str, default=None)
    parser.add_argument("--query-time", type=float, default=0.0)
    parser.add_argument("--frame-fps", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch versions of the kernels)")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="resize / crop / normalise the frames on the device "
                             "(data/device_preprocess.py)")
    parser.add_argument("--output", type=str, default="stream_history.json")
    parser.add_argument("--no-sleep", action="store_true", help="don't pace to real time")
    parser.add_argument("--incremental", action="store_true",
                        help="the carried-state engine (serve/incremental.StreamingSession): "
                             "constant device memory, no full regenerate per response")
    parser.add_argument("--reencode-cache", type=str, default=None,
                        help="ffmpeg re-encode cache dir (reference cli_streaming.py:30-37); "
                             "without ffmpeg the reader's fps resampling stands in")
    return parser.parse_args(argv)


def run(args) -> None:
    """Load the model on ``args.device`` and stream ``args.video_file``."""
    from videollamb_torch.models.builder import load_pretrained_model, resolve_device
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.streaming import LiveInfer

    device = resolve_device(args.device)
    tokenizer, model, cfg, processors, _ = load_pretrained_model(
        args.model_path, args.model_base, video_tower_path=args.video_tower, device=device,
        device_preprocess=args.device_preprocess)
    chat = Chat(tokenizer, model, cfg, processors)
    if args.reencode_cache:
        from videollamb_torch.data.video_reader import ffmpeg_reencode_cached

        args.video_file = ffmpeg_reencode_cached(args.video_file, args.reencode_cache,
                                                 fps=int(args.frame_fps))
    if args.incremental:
        from videollamb_torch.serve.incremental import StreamingSession

        engine = StreamingSession(chat, frame_fps=args.frame_fps, max_seq_len=cfg.max_length)
    else:
        engine = LiveInfer(chat, frame_fps=args.frame_fps)
    main(engine, args)


if __name__ == "__main__":
    run(parse_args())
