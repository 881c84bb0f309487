"""Training step: AdamW per label group, a warmup schedule, gradient accumulation.

Port of ``videollamb_tpu/train/step.py`` (reference HF Trainer + DeepSpeed,
llava/train/llava_trainer.py:149-271). The JAX package builds one optax
transform: ``multi_transform`` over the labels 'train', 'projector' (when
``mm_projector_lr`` is set) and 'frozen', each trained label a chain of
``clip_by_global_norm`` and ``adamw`` on its own schedule, wrapped in
``MultiSteps`` for gradient accumulation. :class:`Optimizer` is the same
transform in PyTorch's parts:

- one ``torch.optim.AdamW`` with a parameter group per trained label, and a
  ``LambdaLR`` whose factor is the schedule's value (the groups' base lr is
  1). optax evaluates a schedule at the count of updates already made, so
  the first update runs at lr(0), which is 0 under warmup; ``LambdaLR``
  does the same, since it steps after the optimizer;
- clipping is per group: each group is scaled by its own global norm, as
  ``multi_transform`` clips each label's leaves apart;
- frozen parameters are in no group: they hold no state and take no
  update, and ``apply_trainable_mask`` turns their gradients off so autograd
  never reaches them (the JAX ``stop_gradient``);
- with ``gradient_accumulation_steps`` k > 1, the step keeps the running
  mean of k gradients (``MultiSteps``' Welford update) and updates, and
  advances the schedule, once per k calls, while ``TrainState.step`` counts
  every call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from videollamb_torch.config import ModelConfig, TrainConfig
from videollamb_torch.models.assembly import (
    MultimodalBatch,
    causal_lm_loss,
    videollamb_forward,
)

TRAINED = ("train", "projector")


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """lr at a count of updates made: linear warmup from 0 over
    ``warmup_ratio`` of the steps, then cosine decay to 0 at ``total_steps``
    (``optax.warmup_cosine_decay_schedule``) or constant ("linear")."""
    warmup = max(1, int(total_steps * cfg.warmup_ratio))
    peak = cfg.learning_rate
    decay = max(total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return -peak * (1.0 - count / warmup) + peak
        if cfg.lr_schedule != "cosine":
            return peak
        t = min(count - warmup, decay)
        return peak * (0.5 * (1.0 + math.cos(math.pi * t / decay)))

    return schedule


def param_labels(cfg: TrainConfig, model: nn.Module) -> Dict[str, str]:
    """Each parameter's group label, 'train', 'projector' or 'frozen', by name.

    One source for :func:`create_optimizer` and :func:`trainable_mask`."""
    labels = {}
    for name, _ in model.named_parameters():
        top = name.split(".", 1)[0]
        if cfg.tune_mode == "lora":
            if top == "mm_projector":
                label = "projector" if cfg.mm_projector_lr is not None else "train"
            elif name.endswith((".lora_a", ".lora_b")):
                label = "train"
            else:
                label = "frozen"
        elif cfg.tune_mode == "adapter":
            label = "train" if top == "mm_projector" else "frozen"
        elif top == "mm_projector" and cfg.mm_projector_lr is not None:
            label = "projector"
        elif top in ("video_tower", "image_tower"):
            label = "frozen"  # the towers are frozen in the recipe
        else:
            label = "train"
        labels[name] = label
    return labels


def trainable_mask(cfg: TrainConfig, model: nn.Module) -> Dict[str, bool]:
    """True for each parameter the optimizer trains (its label is not 'frozen')."""
    return {name: label != "frozen" for name, label in param_labels(cfg, model).items()}


def apply_trainable_mask(model: nn.Module, mask: Optional[Dict[str, bool]]) -> None:
    """``requires_grad`` from the mask; every floating parameter without one."""
    for name, p in model.named_parameters():
        p.requires_grad_(bool(mask[name]) if mask is not None else p.is_floating_point())


class Optimizer:
    """The port of the JAX step's optax transform (see the module docstring)."""

    def __init__(self, cfg: TrainConfig, total_steps: int, groups: Dict[str, List[nn.Parameter]]):
        self.max_grad_norm = cfg.max_grad_norm
        self.k = max(1, cfg.gradient_accumulation_steps)
        lrs = {"train": cfg.learning_rate, "projector": cfg.mm_projector_lr}
        param_groups, schedules = [], []
        for label in TRAINED:
            if groups.get(label):
                param_groups.append({"params": groups[label], "lr": 1.0, "label": label})
                group_cfg = dataclasses.replace(cfg, learning_rate=lrs[label])
                schedules.append(lr_schedule(group_cfg, total_steps))
        if not param_groups:
            raise ValueError("no trainable parameters")
        # The multi-tensor path takes no mix of sharded (DTensor) and plain parameters.
        sharded = any(isinstance(p, DTensor) for g in param_groups for p in g["params"])
        self.adamw = torch.optim.AdamW(param_groups, lr=1.0, betas=(cfg.adam_b1, cfg.adam_b2),
                                       eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                                       foreach=False if sharded else None)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedules)
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for g in self.adamw.param_groups for p in g["params"]]

    @property
    def updates(self) -> int:
        """Updates made so far (the schedule's count)."""
        return self.scheduler.last_epoch

    def update(self, grads: List[torch.Tensor],
               norm_fn: Optional[Callable[[List[nn.Parameter], List[torch.Tensor]],
                                          torch.Tensor]] = None) -> bool:
        """Take one call's gradients (in :attr:`params` order); returns whether
        the parameters were updated (every k-th call). ``norm_fn(params,
        grads)`` gives a group's global norm for the clipping where some
        gradients live on other ranks (the pipeline's stages); the default is
        :func:`global_norm`."""
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                return False
            grads, self.acc = self.acc, None
        it = iter(grads)
        for group in self.adamw.param_groups:
            gs = [next(it) for _ in group["params"]]
            norm = global_norm(gs) if norm_fn is None else norm_fn(group["params"], gs)
            if norm >= self.max_grad_norm:  # optax clip_by_global_norm
                gs = [(g / float(norm) if isinstance(g, DTensor) else g / norm.to(g.dtype))
                      * self.max_grad_norm for g in gs]
            for p, g in zip(group["params"], gs):
                p.grad = g.to(p.dtype)
        self.adamw.step()
        self.scheduler.step()
        self.adamw.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = state["mini_step"]
        self.acc = state["acc"]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all the tensors, in f32 (a sharded
    DTensor's norm covers all its shards)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(
        [n.full_tensor() if isinstance(n, DTensor) else n for n in norms]))


def create_optimizer(cfg: TrainConfig, total_steps: int, model: nn.Module) -> Optimizer:
    labels = param_labels(cfg, model)
    groups: Dict[str, List[nn.Parameter]] = {label: [] for label in TRAINED}
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            groups[labels[name]].append(p)
    return Optimizer(cfg, total_steps, groups)


@dataclasses.dataclass
class TrainState:
    """``step`` counts calls of the step; the model and optimizer are updated in place."""

    step: int
    model: nn.Module
    tx: Optimizer


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, tx=tx)


def make_train_step(model_cfg: ModelConfig, tx: Optimizer, *, remat: bool = True,
                    attn_impl: str = "chunked", rmt_loss: bool = False,
                    mask: Optional[Dict[str, bool]] = None) -> Callable:
    """Build the step: (state, batch, generator) -> (state, metrics).

    The attention is the differentiable chunked route; ``rmt_loss`` takes the
    per-segment retro loss (``train/retro.py``). ``mask``
    (:func:`trainable_mask`) turns gradients off for frozen parameters, so a
    frozen tower runs forward only and keeps no activations; without one
    every floating parameter is differentiated. A ``generator`` turns the
    bridge's dropout on. Metrics: the loss, the count of supervised tokens,
    and ``grad_norm``, the global norm of this call's gradients of the
    differentiated parameters, before clipping."""

    def train_step(state: TrainState, batch: MultimodalBatch,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        apply_trainable_mask(model, mask)
        params = tx.params
        with torch.enable_grad():
            if rmt_loss:
                from videollamb_torch.train.retro import retro_loss

                loss, n_tokens = retro_loss(model, model_cfg, batch, generator=generator,
                                            remat=remat, attn_impl=attn_impl)
            else:
                logits, spliced = videollamb_forward(model, model_cfg, batch, generator,
                                                     remat=remat, attn_impl=attn_impl)
                loss, n_tokens = causal_lm_loss(logits, spliced.labels)
            wanted = [p for p in model.parameters() if p.requires_grad]
            # A batch may reach no trained parameter (text rows, adapter mode).
            grads = (torch.autograd.grad(loss, wanted, allow_unused=True) if loss.requires_grad
                     else [None] * len(wanted))
        grads = {p: torch.zeros_like(p) if g is None else g for p, g in zip(wanted, grads)}
        grad_norm = global_norm(list(grads.values()))
        tx.update([grads[p] if p in grads else torch.zeros_like(p) for p in params])
        metrics = {"loss": loss.detach(), "tokens": n_tokens, "grad_norm": grad_norm}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
