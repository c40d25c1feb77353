"""The train step and the elastic, preemptible training job used by the
PhoenixCloud PBJ TRE: the counterpart of ``repro.train.trainer``.

``make_train_step`` builds the (params, opt_state, batch, lr) →
(params, opt_state, metrics) step: the model's loss, ``backward``, then
the optimizer's in-place update. With ``accum_steps > 1`` the batch is
split into micro-batches whose float32 gradients are summed and
averaged, as the reference's ``lax.scan`` does; activation memory then
scales with the micro-batch.

``TrainJob`` builds its ``Model`` with ``impl="torch"``, the plain tensor
path, differentiated by autograd. That is the reference's own choice:
its trainer builds ``Model`` with the default ``impl="xla"``, the jnp
path used for training, and its Pallas kernels have no backward. The
CUDA kernels serve prefill and decode; training runs none of them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.compat import Device, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Model
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import make_source
from repro_torch.train.optimizer import (Optimizer, get_optimizer,
                                         global_norm, tree_leaves, tree_map)

__all__ = ["make_train_step", "TrainJobConfig", "TrainJob"]

PyTree = Any


def _grads(params: PyTree) -> PyTree:
    """The parameters' gradients as a tree, taken off the parameters
    (zeros where a parameter got none)."""
    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g
    return tree_map(take, params)


def make_train_step(model: Model, optimizer: Optimizer,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch, lr) → (params,
    opt_state, {"loss", "grad_norm"}). ``params`` is ``model.params()``,
    whose tensors require grad; they and ``opt_state`` are updated in
    place. ``batch`` has a leading global batch (numpy arrays or
    tensors); with ``accum_steps > 1`` it is cut into ``accum_steps``
    micro-batches of consecutive rows. ``grad_norm`` is the global norm
    of the (averaged) gradients before the optimizer's clip."""

    def train_step(params, opt_state, batch, lr):
        if accum_steps == 1:
            loss = model.loss(batch)
            loss.backward()
            grads = _grads(params)
        else:
            micro = batch["tokens"].shape[0] // accum_steps
            acc, loss = None, 0.0
            for i in range(accum_steps):
                mb = {k: v[i * micro:(i + 1) * micro]
                      for k, v in batch.items()}
                mloss = model.loss(mb)
                mloss.backward()
                g = tree_map(lambda x: x.to(torch.float32), _grads(params))
                acc = g if acc is None else tree_map(
                    lambda a, b: a.add_(b), acc, g)
                loss = loss + mloss.detach()
            grads = tree_map(lambda g: g.div_(accum_steps), acc)
            loss = loss / accum_steps
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


@dataclasses.dataclass
class TrainJobConfig:
    arch: str
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    seed: int = 0
    accum_steps: int = 1
    data_path: Optional[str] = None


def _meta(tree: PyTree) -> PyTree:
    """Shape-only stand-ins of a tree's tensors (a restore template)."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


class TrainJob:
    """An elastic, preemptible training job — the payload a PhoenixCloud
    PBJ TRE schedules. Supports checkpoint-preempt (§5.1 adaptation):
    ``preempt()`` stops after the current step, ``checkpoint()`` saves;
    ``run()`` of a new job on the same directory restores and resumes.

    The third argument keeps the reference's place for the mesh (the
    runtime bridge passes its own); here it is the device: ``None`` is
    the current CUDA device (raises without one), ``"cpu"`` the CPU.
    """

    def __init__(self, cfg: ArchConfig, job: TrainJobConfig,
                 mesh: Device = None, compute_dtype=torch.float32):
        self.cfg = cfg
        self.jc = job
        self.device = resolve_device(mesh)
        self.model = Model(cfg, self.device, impl="torch",
                           compute_dtype=compute_dtype)
        self.model.requires_grad_(True)
        self.optimizer = get_optimizer(cfg.optimizer, lr=job.lr)
        self.source = make_source(cfg, job.batch, job.seq_len,
                                  path=job.data_path, seed=job.seed)
        self.ckpt = Checkpointer(job.checkpoint_dir) \
            if job.checkpoint_dir else None
        self._preempt = False
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history = []
        self.grad_norms = []

    # -------------------------------------------------------------- state

    def initialize(self):
        params = self.model.params()
        if self.ckpt and self.ckpt.latest_step() is not None:
            step = self.ckpt.latest_step()
            tpl = _meta({"params": params,
                         "opt": self.optimizer.init(_meta(params))})
            state, meta = self.ckpt.restore(step, tpl, device=self.device)
            with torch.no_grad():
                for p, saved in zip(tree_leaves(params),
                                    tree_leaves(state["params"])):
                    p.copy_(saved)
            self.opt_state = state["opt"]
            self.step = int(meta["step"])
        else:
            self.model.init(self.jc.seed)
            self.opt_state = self.optimizer.init(params)
            self.step = 0
        self.params = params

    def preempt(self):
        self._preempt = True

    def checkpoint(self, block: bool = False):
        if not self.ckpt:
            return
        self.ckpt.save_async(self.step,
                             {"params": self.params, "opt": self.opt_state},
                             metadata={"step": self.step})
        if block:
            self.ckpt.wait()

    # ---------------------------------------------------------------- run

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in self.source.batch_at(step).items()}

    def run(self) -> Dict:
        if self.params is None:
            self.initialize()
        step_fn = make_train_step(self.model, self.optimizer,
                                  self.jc.accum_steps)
        self._preempt = False
        t0 = time.time()
        while self.step < self.jc.steps and not self._preempt:
            _, _, metrics = step_fn(self.params, self.opt_state,
                                    self._batch(self.step), self.jc.lr)
            self.step += 1
            self.history.append(float(metrics["loss"]))
            self.grad_norms.append(float(metrics["grad_norm"]))
            if self.ckpt and self.step % self.jc.checkpoint_every == 0:
                self.checkpoint()
        if self.ckpt:
            self.checkpoint(block=True)
        return {
            "completed": self.step >= self.jc.steps,
            "step": self.step,
            "loss": self.history[-1] if self.history else None,
            "wall_seconds": time.time() - t0,
        }
