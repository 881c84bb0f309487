"""Training entry point: ``python -m videollamb_torch.train.cli ...``.

Port of ``videollamb_tpu/train/cli.py`` (reference llava/train/train.py:887-1141
and scripts/finetune_video_image.slurm) with the same flags, plus
``--device`` (``cuda`` by default; ``--device cpu`` trains on the host).
The model loads from a reference-format checkpoint; a checkpoint without a
projector starts a seeded one of the ``--mm_projector_type`` kind (any kind
of the factory, ``models/bridge/builder.py``: the classic LLaVA stage 1 is an
``mlp2x_gelu`` pretrain). ``--rmt_loss`` needs the RMT-R bridge's segments:
the Trainer refuses another kind before the first step. The trained parameters are f32 masters; the
frozen base and towers stay in bf16 with ``--bf16 True`` (the default), and
every product runs in the activations' dtype, as the JAX ``_proj`` casts.

Image rows (``--image_folder``, ``--image_aspect_ratio`` square / pad /
anyres) and audio rows (``--audio_folder``, WAV) reach the dataset as in
the JAX package; the image and video processors take the model's tower
size.

Several GPUs: one process a card under ``torchrun`` (``torchrun
--nproc_per_node 4 -m videollamb_torch.train.cli ...``; with ``--device
cpu`` the ranks run on the host over gloo). ``--sequence_parallel n``
replicates the parameters and splits the spliced token stream over n ranks
(a ('data', 'seq') mesh, the sequence-parallel step); otherwise the ranks
form a ('data', 'model') mesh with ``--model_parallel`` ranks of tensor
parallelism, and the model is sharded (``parallel/sharding.shard_params``:
TP, then FSDP over 'data'). ``--sequence_parallel`` excludes
``--model_parallel``, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # Model arguments (reference ModelArguments, train.py:56-85)
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--version", type=str, default="v1")
    p.add_argument("--image_tower", type=str, default=None)
    p.add_argument("--video_tower", type=str, default=None)
    p.add_argument("--mm_projector_type", type=str, default="rmt_r_transformer1x")
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None)
    p.add_argument("--tune_mm_mlp_adapter", action="store_true")
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--mm_use_x_start_end", action="store_true")
    p.add_argument("--mm_vision_select_layer", type=int, default=-2)
    p.add_argument("--rmt_loss", action="store_true",
                   help="per-segment RMT LM loss (reference '_rmt' path)")
    # Data arguments (reference DataArguments)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--image_folder", type=str, default="")
    p.add_argument("--video_folder", type=str, default="")
    p.add_argument("--audio_folder", type=str, default="",
                   help="root for 'audio' (WAV) samples; pairs with an audio "
                        "--image_tower (AUDIO modality extension)")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--image_aspect_ratio", type=str, default="pad")
    # Training arguments (reference TrainingArguments)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--mm_projector_lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--save_steps", type=int, default=50000)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--bf16", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--gradient_checkpointing", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="shard the spliced token stream over this many "
                        "ranks (excludes --model_parallel)")
    p.add_argument("--lora_enable", action="store_true")
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--lora_alpha", type=int, default=256)
    p.add_argument("--pack_sequences", action="store_true",
                   help="pack several conversations per row (segment-ID "
                        "block-causal attention; each step trains "
                        "pack_factor x the samples at the same shape)")
    p.add_argument("--pack_factor", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="device to train on (cpu for a host run)")
    return p.parse_args(argv)


def train_config(args):
    from videollamb_torch.config import TrainConfig

    return TrainConfig(
        learning_rate=args.learning_rate, mm_projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        lr_schedule=args.lr_scheduler_type, num_train_epochs=args.num_train_epochs,
        per_device_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps, seed=args.seed,
        bf16=args.bf16, gradient_checkpointing=args.gradient_checkpointing,
        tune_mode="adapter" if args.tune_mm_mlp_adapter else (
            "lora" if args.lora_enable else "full"),
        lora_r=args.lora_r, lora_alpha=args.lora_alpha, save_steps=args.save_steps,
        save_total_limit=args.save_total_limit, logging_steps=args.logging_steps,
        output_dir=args.output_dir, rmt_loss=args.rmt_loss,
        pack_sequences=args.pack_sequences, pack_factor=args.pack_factor)


def _distributed(args) -> bool:
    """Join the ``torchrun`` group (gloo for ``--device cpu``, else NCCL, one
    card a rank); False for a single process."""
    parallel = args.sequence_parallel > 1 or args.model_parallel > 1
    if args.sequence_parallel > 1 and args.model_parallel > 1:
        raise ValueError("--sequence_parallel excludes --model_parallel")
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) == 1:
            if parallel:
                raise ValueError(
                    "--sequence_parallel / --model_parallel above 1 need as many ranks: "
                    "run under torchrun --nproc_per_node N")
            return False
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    if args.device != "cpu" and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    return True


def main(argv=None, tokenizer=None, log_fn=None):
    """Parse the flags and train; ``tokenizer`` replaces the checkpoint's
    (tests), ``log_fn`` receives each step's metrics (rank 0 prints them by
    default)."""
    args = parse_args(argv)
    distributed = _distributed(args)

    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.models.lm.lora import add_lora_params
    from videollamb_torch.train.dataset import Collator, DataConfig, SupervisedDataset
    from videollamb_torch.train.preprocess import set_default_conversation
    from videollamb_torch.train.step import param_labels, trainable_mask
    from videollamb_torch.train.trainer import Trainer

    set_default_conversation(args.version)
    loaded_tokenizer, model, model_cfg, _, _ = load_pretrained_model(
        args.model_name_or_path, video_tower_path=args.video_tower,
        image_tower_path=args.image_tower, dtype="bfloat16" if args.bf16 else "float32",
        load_tokenizer=tokenizer is None, device=args.device, bridge_seed=args.seed,
        projector_type=args.mm_projector_type)
    tokenizer = tokenizer or loaded_tokenizer
    if args.pretrain_mm_mlp_adapter:
        sd = torch.load(args.pretrain_mm_mlp_adapter, map_location="cpu", weights_only=True)
        prefix = "model.mm_projector." if any(
            k.startswith("model.mm_projector.") for k in sd) else "mm_projector."
        model.mm_projector.load_state_dict(
            {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    if args.lora_enable:
        device = next(model.lm.parameters()).device
        add_lora_params(model.lm, model_cfg.lm, r=args.lora_r, alpha=args.lora_alpha,
                        generator=torch.Generator(device=device).manual_seed(args.seed + 1))

    tcfg = train_config(args)
    # f32 masters for what trains; the frozen rest keeps the loaded dtype.
    labels = param_labels(tcfg, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if labels[name] != "frozen":
                p.data = p.data.float()
    mesh = step_factory = None
    if distributed and args.sequence_parallel > 1:
        step_factory, data_count, data_index = _seq_parallel_factory(args, trainable_mask(
            tcfg, model))
    elif distributed:
        from videollamb_torch.parallel.mesh import create_mesh
        from videollamb_torch.parallel.sharding import batch_sharding, shard_params

        mesh = create_mesh(model_parallel=args.model_parallel)
        shard_params(mesh, model)
        data_count, data_index = batch_sharding(mesh)
    else:
        data_count, data_index = 1, 0
    dcfg = DataConfig(
        data_path=args.data_path, image_folder=args.image_folder,
        video_folder=args.video_folder, audio_folder=args.audio_folder,
        num_frames=args.num_frames, mm_use_x_start_end=args.mm_use_x_start_end,
        model_max_length=args.model_max_length, image_aspect_ratio=args.image_aspect_ratio)
    dataset = SupervisedDataset(
        args.data_path, tokenizer, dcfg,
        video_processor=VideoProcessor(size=model_cfg.vision.image_size, training=True),
        image_processor=ImageProcessor(size=model_cfg.vision.image_size),
        seed=args.seed)
    if log_fn is None:
        from videollamb_torch.utils.logging import rank0_print

        log_fn = lambda m: rank0_print(m, flush=True)  # noqa: E731
    trainer = Trainer(
        model_cfg, tcfg, model, dataset,
        collator=None if args.pack_sequences else Collator(
            pad_token_id=int(tokenizer.pad_token_id or 0), max_length=args.model_max_length),
        log_fn=log_fn, process_count=data_count, process_index=data_index, mesh=mesh,
        step_factory=step_factory)
    return trainer.train()


def _seq_parallel_factory(args, mask):
    """The sequence-parallel step over a ('data', 'seq') mesh of the world's
    ranks: (factory, data ranks, this rank's data index)."""
    from torch.distributed.device_mesh import init_device_mesh

    from videollamb_torch.parallel.mesh import mesh_device_type
    from videollamb_torch.parallel.seq_parallel import make_seq_parallel_videollamb_step

    n_seq = args.sequence_parallel
    world = dist.get_world_size()
    if world % n_seq:
        raise ValueError(f"{world} ranks do not split into sequence_parallel={n_seq}")
    n_data = world // n_seq
    mesh = init_device_mesh(mesh_device_type(), (n_data, n_seq), mesh_dim_names=("data", "seq"))

    def factory(model_cfg, tx, train_cfg):
        return make_seq_parallel_videollamb_step(
            mesh, model_cfg, tx, data_axis="data" if n_data > 1 else None,
            remat=train_cfg.gradient_checkpointing, mask=mask)

    return factory, n_data, mesh.get_local_rank("data")


if __name__ == "__main__":
    main()
