"""Training runtime (port of ``repro.runtime.train_loop``): the train step
(autograd over the parameter leaves, f32 gradient accumulation over
microbatches, optional int8 gradient compression, AdamW) and the Trainer
loop with fault tolerance (async checkpoints, preemption handler,
straggler watchdog).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.analysis.cost import trip_count
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StepWatchdog
from repro_torch.runtime.grad_compress import compress_gradients
from repro_torch.sharding.api import shard
from repro_torch.tree import leaves, tree_map, unflatten

Params = Dict[str, Any]


def make_train_step(cfg, opt_cfg, grad_accum: int = 1,
                    grad_compression: str = "none", *,
                    count_only: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and moments are updated in place.

    grad_accum > 1: the batch is split into ``grad_accum`` microbatches run
    one after another, each gradient divided by ``grad_accum`` and summed
    in f32 (the reference's ``scan``).  Every metric stays a device
    tensor: the step reads nothing back to the host.

    ``count_only`` is the dry-run's step (``launch.dryrun``, on fake
    tensors whose values nothing reads): the microbatch loop's body runs
    once and the cost analyzer counts it ``grad_accum`` times
    (``analysis.cost.trip_count``, as the reference's analyzer multiplies
    its ``scan`` body by the trip count), and a parameter the loss does
    not read (a layer stack cut to 0 layers) gets zero gradients.  A real
    step keeps autograd strict: such a parameter raises.
    """
    api = get_model(cfg)

    def value_and_grad(params: Params, mb: Params):
        # fresh leaves that alias the parameters' storage: autograd's graph
        # ends here and is freed by autograd.grad, before the in-place update
        flat = [x.detach().requires_grad_() for x in leaves(params)]
        loss, metrics = api.loss(unflatten(params, flat), cfg, mb)
        grads = torch.autograd.grad(loss, flat, allow_unused=count_only)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, flat)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            unflatten(params, grads)

    def train_step(params: Params, opt_state: Params, batch: Params):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum "
                                 f"{grad_accum}")
            micro = {k: v.reshape(grad_accum, b // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            # laid out as the parameters (a DTensor leaf's accumulator is
            # one too)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = 0.0
            with (trip_count(grad_accum) if count_only
                  else contextlib.nullcontext()):
                for i in range(1 if count_only else grad_accum):
                    mb = {k: v[i] for k, v in micro.items()}
                    # split over the data axes as the batch is (an
                    # activation hook: the identity without rules)
                    mb["tokens"] = shard(mb["tokens"], "tokens")
                    l, _, g = value_and_grad(params, mb)
                    for acc, x in zip(leaves(grads), leaves(g)):
                        acc.add_(x.float() / grad_accum)
                    loss = loss + l / grad_accum
                    del g
            zero = torch.zeros((), device=loss.device)
            metrics = {"nll": loss, "aux": zero, "z": zero}
        if grad_compression == "int8":
            grads = compress_gradients(grads)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Single-process training loop with checkpoint/restart semantics.

    Resume is exact: data batches are a pure function of the step index,
    and optimizer state + params round-trip through the checkpointer
    losslessly.  ``device`` (the card by default) holds the params, the
    optimizer state and every batch.
    """

    def __init__(self, train_cfg, stream=None, device: DeviceLike = None):
        self.cfg = train_cfg
        self.model_cfg = train_cfg.model
        self.device = resolve_device(device)
        self.api = get_model(self.model_cfg)
        self.stream = stream or SyntheticStream(
            self.model_cfg.vocab_size, train_cfg.global_batch,
            train_cfg.seq_len, seed=train_cfg.seed)
        self.step_fn = make_train_step(self.model_cfg, train_cfg.optimizer,
                                       self.model_cfg.grad_accum,
                                       train_cfg.grad_compression)
        self.ckpt = Checkpointer(train_cfg.checkpoint_dir,
                                 keep=train_cfg.keep_checkpoints)
        self.watchdog = StepWatchdog()
        self.preemption = PreemptionHandler()
        self.metrics_log: list = []

    def init_state(self) -> Tuple[Params, Params, int]:
        params = self.api.init_params(self.model_cfg, self.cfg.seed,
                                      self.device)
        opt_state = init_opt_state(params, self.cfg.optimizer)
        return params, opt_state, 0

    def restore_or_init(self) -> Tuple[Params, Params, int]:
        latest = self.ckpt.latest_step()
        params, opt_state, _ = self.init_state()
        if latest is None:
            return params, opt_state, 0
        state = self.ckpt.restore(latest, {"params": params, "opt": opt_state})
        return state["params"], state["opt"], latest

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        params, opt_state, start = self.restore_or_init()
        total = steps if steps is not None else self.cfg.steps
        step = start
        for step in range(start, total):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.stream.batch_at(step).items()}
            t0 = time.monotonic()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            # the watchdog needs the device-inclusive step time: this sync
            # is the measurement (the step itself reads nothing back)
            _sync(self.device)
            self.watchdog.record(step, time.monotonic() - t0)
            if step % self.cfg.log_every == 0 or step == total - 1:
                # log-cadence host reads of already-synced scalars
                self.metrics_log.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "lr": float(metrics["lr"])})
            want_ckpt = ((step + 1) % self.cfg.checkpoint_every == 0
                         or step == total - 1)
            if self.preemption.triggered:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                               blocking=True)
                break
            if want_ckpt:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                               blocking=not self.cfg.async_checkpoint)
        self.ckpt.wait()
        return {"params": params, "opt": opt_state, "step": step + 1,
                "log": self.metrics_log,
                "stragglers": self.watchdog.stragglers}
