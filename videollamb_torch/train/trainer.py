"""Training loop: sample order, host loading ahead of the device, the step,
checkpoints with auto-resume, logging, and a clean stop on SIGTERM.

Port of ``videollamb_tpu/train/trainer.py`` (reference
llava/train/train.py:887-1141 and llava_trainer.py), on one device or, under
``torchrun``, one rank a device (``parallel/``):

- the modality-grouped order of ``train/dataset.py``; with several
  processes each decodes its own slice of every global batch
  (:func:`process_local_order`);
- :class:`Prefetcher`: worker threads decode and collate a bounded number
  of batches ahead (``depth``), and on resume skipped batches are never
  decoded;
- batches are pinned in the worker and copied to the device with
  ``non_blocking``, so the copy overlaps the step;
- :class:`GracefulShutdown`: SIGTERM or SIGINT finishes the step in flight,
  checkpoints and returns, so a preempted run loses at most one step;
- a ``torch.Generator`` on the model's device, seeded by the config and
  kept in the checkpoint, draws the dropout masks;
- with a ``mesh`` (a model sharded by ``parallel/sharding.shard_params``)
  the step is the sharded one; a ``step_factory(model_cfg, tx, train_cfg)``
  (the sequence-parallel step) replaces the step, as in the JAX Trainer.
  Each data rank decodes its slice of the batches; checkpoints gather the
  full state and rank 0 writes them.
"""

from __future__ import annotations

import queue
import signal
import threading
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from videollamb_torch.config import ModelConfig, TrainConfig
from videollamb_torch.models.assembly import MultimodalBatch, measure_block_tokens
from videollamb_torch.models.bridge.builder import RMT_R
from videollamb_torch.train.checkpoint import maybe_resume, save_checkpoint
from videollamb_torch.train.dataset import Collator, PackedCollator, modality_grouped_indices
from videollamb_torch.train.step import (
    TrainState,
    create_optimizer,
    create_train_state,
    make_train_step,
    trainable_mask,
)


def process_local_order(order: List[int], global_batch: int, process_count: int,
                        process_index: int) -> List[int]:
    """This process's rows of a global order: the ``process_index``-th
    contiguous chunk of every global batch (reference llava_trainer.py:59-146)."""
    local = global_batch // process_count
    out: List[int] = []
    for start in range(0, len(order) - global_batch + 1, global_batch):
        gb = order[start: start + global_batch]
        out.extend(gb[process_index * local: (process_index + 1) * local])
    return out


class Prefetcher:
    """Background threads keep up to ``depth`` collated batches ready.

    Batches before ``start_batch`` are never queued, so a resumed run decodes
    nothing it skips. Workers wait once ``depth`` batches past the consumer
    are ready, so host memory holds O(depth) batches whatever the epoch's
    length."""

    def __init__(self, dataset, order: List[int], batch_size: int, collator: Callable,
                 num_threads: int = 2, start_batch: int = 0, depth: int = 4):
        self.dataset = dataset
        self.order = order
        self.batch_size = batch_size
        self.collator = collator
        self.num_batches = len(order) // batch_size
        self.start_batch = min(start_batch, self.num_batches)
        self.depth = max(depth, num_threads)
        self._batch_queue = queue.Queue()
        for b in range(self.start_batch, self.num_batches):
            self._batch_queue.put(b)
        self._results = {}
        self._errors = {}
        self._next = self.start_batch  # the next batch the consumer takes
        self._stopped = False
        self._cv = threading.Condition()
        self._threads = []
        for _ in range(num_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while True:
            try:
                b = self._batch_queue.get_nowait()
            except queue.Empty:
                return
            with self._cv:
                while not self._stopped and b >= self._next + self.depth:
                    self._cv.wait()
                if self._stopped:
                    return
            idxs = self.order[b * self.batch_size: (b + 1) * self.batch_size]
            try:
                batch = self.collator([self.dataset[i] for i in idxs])
            except Exception as e:  # handed to the consumer, which raises it
                with self._cv:
                    self._errors[b] = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._results[b] = batch
                self._cv.notify_all()

    def stop(self) -> None:
        """Release the workers early (a preempted or abandoned epoch)."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def __iter__(self) -> Iterator:
        for b in range(self.start_batch, self.num_batches):
            with self._cv:
                while b not in self._results:
                    if b in self._errors:
                        self._stopped = True
                        self._cv.notify_all()
                        raise self._errors[b]
                    if self._stopped:
                        return
                    self._cv.wait()
                batch = self._results.pop(b)
                self._next = b + 1
                self._cv.notify_all()
            yield batch


class GracefulShutdown:
    """SIGTERM / SIGINT -> finish the current step, checkpoint, return.

    The handler only sets a flag, which the loop reads after every step.
    A context manager restoring the earlier handlers on exit; outside the
    main thread signals cannot be caught, and the flag is set by
    :meth:`request` only."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._flag = threading.Event()
        self._prev = {}

    def __enter__(self) -> "GracefulShutdown":
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread
            self._prev = {}
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def _handle(self, signum, frame) -> None:
        self._flag.set()

    def request(self) -> None:
        """Preempt from code (tests, an outside scheduler)."""
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()


def pin_batch(batch: MultimodalBatch, device: torch.device) -> MultimodalBatch:
    """numpy fields -> tensors, in pinned host memory when bound for a card."""
    def one(x):
        if x is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.dtype == torch.int32:
            t = t.long()
        return t.pin_memory() if device.type == "cuda" else t

    return MultimodalBatch(*(one(x) for x in batch))


def to_device(batch: MultimodalBatch, device: torch.device) -> MultimodalBatch:
    return MultimodalBatch(*(None if x is None else x.to(device, non_blocking=True)
                             for x in batch))


class Trainer:
    """End-to-end training loop on one device."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, model: torch.nn.Module,
                 dataset, collator: Optional[Callable] = None,
                 log_fn: Optional[Callable[[dict], None]] = None,
                 process_count: Optional[int] = None, process_index: Optional[int] = None,
                 mesh=None, step_factory: Optional[Callable] = None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.dataset = dataset
        if train_cfg.pack_sequences and (train_cfg.rmt_loss or step_factory is not None):
            # The retro path and the other step factories splice without
            # segment routing: packed rows would attend across conversations.
            raise ValueError("pack_sequences is incompatible with rmt_loss and custom step "
                             "factories")
        if train_cfg.rmt_loss and step_factory is not None:
            # As in the JAX package, whose step factories ignore rmt_loss.
            raise NotImplementedError("rmt_loss takes no step factory")
        if train_cfg.rmt_loss and model_cfg.bridge.kind != RMT_R:
            raise ValueError(
                f"rmt_loss trains on every segment of the {RMT_R} bridge; this model's "
                f"projector is {model_cfg.bridge.projector_type!r}")
        self.log_fn = log_fn or (lambda m: print(m, flush=True))
        if mesh is not None and process_count is None:
            from videollamb_torch.parallel.sharding import batch_sharding

            process_count, process_index = batch_sharding(mesh)
        self.process_count = process_count or 1
        self.process_index = process_index or 0
        self.device = next(model.parameters()).device
        self.global_batch = train_cfg.per_device_batch_size * self.process_count

        if collator is not None:
            self.collator = collator
        elif train_cfg.pack_sequences:
            data_cfg = getattr(dataset, "cfg", None)
            self.collator = PackedCollator(
                max_length=model_cfg.max_length,
                block_tokens=measure_block_tokens(model_cfg, "video"),
                block_tokens_image=measure_block_tokens(model_cfg, "image"),
                fixed_rows=max(1, self.global_batch // self.process_count),
                fixed_frames=getattr(data_cfg, "num_frames", None))
        else:
            self.collator = Collator(max_length=model_cfg.max_length)
        samples_per_step = self.global_batch * (
            max(1, train_cfg.pack_factor) if train_cfg.pack_sequences else 1)
        steps_per_epoch = max(1, len(dataset) // samples_per_step)
        self.total_steps = steps_per_epoch * train_cfg.num_train_epochs

        self.tx = create_optimizer(train_cfg, self.total_steps, model)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.state = maybe_resume(train_cfg.output_dir, create_train_state(model, self.tx),
                                  self.generator)
        mask = trainable_mask(train_cfg, model)
        if step_factory is not None:
            self.step_fn = step_factory(model_cfg, self.tx, train_cfg)
        elif mesh is not None:
            from videollamb_torch.parallel.sharding import make_sharded_train_step

            self.step_fn = make_sharded_train_step(
                mesh, model_cfg, self.tx, remat=train_cfg.gradient_checkpointing,
                rmt_loss=train_cfg.rmt_loss, mask=mask)
        else:
            self.step_fn = make_train_step(
                model_cfg, self.tx, remat=train_cfg.gradient_checkpointing,
                rmt_loss=train_cfg.rmt_loss, mask=mask)

    def _batch_order(self, epoch: int) -> List[int]:
        """This process's sample order: the same seeded global order on every
        process, then this process's slice of each batch."""
        order = modality_grouped_indices(
            self.dataset.modality_lengths(),
            batch_size=max(1, self.global_batch // self.process_count),
            world_size=self.process_count, seed=self.train_cfg.seed + epoch)
        if self.process_count == 1:
            return order
        return process_local_order(order, self.global_batch, self.process_count,
                                   self.process_index)

    def train(self, shutdown: Optional[GracefulShutdown] = None) -> TrainState:
        """Run the recipe. A SIGTERM / SIGINT (or ``shutdown.request()``) ends it
        after the step in flight, with a checkpoint."""
        if shutdown is None:
            with GracefulShutdown() as shutdown:
                return self._train_loop(shutdown)
        return self._train_loop(shutdown)

    def _train_loop(self, shutdown: GracefulShutdown) -> TrainState:
        start_step = self.state.step
        local_batch = max(1, self.global_batch // self.process_count)
        if self.train_cfg.pack_sequences:
            local_batch *= max(1, self.train_cfg.pack_factor)
        collate = lambda samples: pin_batch(self.collator(samples), self.device)  # noqa: E731
        for epoch in range(self.train_cfg.num_train_epochs):
            order = self._batch_order(epoch)
            num_batches = len(order) // local_batch
            skip = min(max(start_step - epoch * num_batches, 0), num_batches)
            prefetcher = Prefetcher(self.dataset, order, local_batch, collate, start_batch=skip)
            for batch in prefetcher:
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, to_device(batch, self.device),
                                                   self.generator)
                step = self.state.step
                if step % self.train_cfg.logging_steps == 0:
                    self.log_fn({"step": step, "loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "tokens": int(metrics["tokens"]),
                                 "step_time": round(time.perf_counter() - t0, 3)})
                if shutdown.requested:
                    prefetcher.stop()
                    self._save(step)
                    self.log_fn({"step": step, "preempted": True, "checkpointed": True})
                    return self.state
                if self.train_cfg.save_steps and step % self.train_cfg.save_steps == 0:
                    self._save(step)
        self._save(self.state.step)
        return self.state

    def _save(self, step: int) -> None:
        save_checkpoint(self.train_cfg.output_dir, self.state, step=step,
                        save_total_limit=self.train_cfg.save_total_limit,
                        adapter_only=(self.train_cfg.tune_mode == "adapter"),
                        generator=self.generator)
