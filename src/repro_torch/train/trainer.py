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

On a layout of several devices (a ``launch.mesh.Layout`` with a
``DeviceMesh``) the weights and the optimizer state are DTensors placed
by ``Model.param_specs`` and ``Optimizer.state_specs``, the batch is
sharded by ``batch_pspecs``, and the step is the same code under
DTensor's sharding propagation. Micro-batches are the reference's
consecutive global slices of the batch, each placed by
``batch_pspecs``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.compat import Device, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import AxisSizes, entry, is_dtensor
from repro_torch.models.transformer import Model
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import make_source
from repro_torch.train.optimizer import (Optimizer, get_optimizer,
                                         global_norm, tree_leaves, tree_map)

__all__ = ["batch_pspecs", "make_train_step", "TrainJobConfig", "TrainJob"]

PyTree = Any


def batch_pspecs(cfg: ArchConfig, ax: AxisSizes) -> Dict:
    """The reference's batch specs: rows over the batch axes."""
    rows = entry(ax.batch_axes)
    specs = {"tokens": (rows, None), "labels": (rows, None)}
    if cfg.family in ("vlm", "audio"):
        specs["frontend"] = (rows, None, None)
    return specs


def _micro_batches(batch: Dict, n: int, model: Model):
    """The ``n`` micro-batches of ``batch``, as the reference's reshape to
    ``(n, B // n, ...)`` makes them: micro-batch ``i`` is the global rows
    ``[i·B/n, (i+1)·B/n)``. ``B`` must divide by ``n``.

    On a mesh a leaf sharded along its rows is gathered once (an
    all-gather of the step's rows, where GSPMD moves them for its
    reshape), and each micro-batch is placed by ``batch_pspecs`` with the
    divisibility fallback: a micro-batch of fewer rows than there are
    batch ranks is whole on each of them, as in the reference."""
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(f"the batch's rows {sorted(rows)} do not split "
                         f"into {n} equal micro-batches")
    m = next(iter(rows)) // n
    specs = batch_pspecs(model.cfg, model.ax) if model.mesh is not None \
        else {}
    whole = {k: v.full_tensor() if is_dtensor(v) else v
             for k, v in batch.items()}

    def place(k, v):
        if not is_dtensor(batch[k]):
            return v
        from torch.distributed.tensor import distribute_tensor
        ax = model.ax
        pl = ax.placements(ax.spec(specs[k], v.shape)) if k in specs \
            else batch[k].placements
        return distribute_tensor(v, ax.mesh, pl, src_data_rank=None)

    return [{k: place(k, v[i * m:(i + 1) * m]) for k, v in whole.items()}
            for i in range(n)]


def _grads(params: PyTree) -> PyTree:
    """The parameters' gradients as a tree, taken off the parameters
    (zeros where a parameter got none)."""
    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g
    return tree_map(take, params)


def make_train_step(model: Model, optimizer: Optimizer,
                    accum_steps: int = 1, grad_pspecs=None) -> Callable:
    """Returns train_step(params, opt_state, batch, lr) → (params,
    opt_state, {"loss", "grad_norm"}). ``params`` is ``model.params()``,
    whose tensors require grad; they and ``opt_state`` are updated in
    place. ``batch`` has a leading global batch (numpy arrays or
    tensors); with ``accum_steps > 1`` it is cut into ``accum_steps``
    micro-batches of consecutive global rows (``_micro_batches``). ``grad_norm`` is the global norm of the
    (averaged) gradients before the optimizer's clip.

    ``grad_pspecs`` (the parameters' specs) pins the gradients and the
    float32 accumulator of a model on a mesh to the parameters'
    placements, as the reference pins its accumulator: without it each
    gradient keeps the placement the backward pass gave it."""
    pin = None
    if grad_pspecs is not None and model.mesh is not None \
            and model.mesh.size() > 1:
        placements = tree_map(model.ax.placements, grad_pspecs)

        def pin(tree):
            return tree_map(lambda g, pl: g.redistribute(
                model.mesh, pl) if is_dtensor(g) else g, tree, placements)

    def grads_of(params):
        g = _grads(params)
        return pin(g) if pin is not None else g

    def train_step(params, opt_state, batch, lr):
        if accum_steps == 1:
            loss = model.loss(batch)
            with model.sharded():
                loss.backward()
            grads = grads_of(params)
        else:
            acc, loss = None, 0.0
            for mb in _micro_batches(batch, accum_steps, model):
                mloss = model.loss(mb)
                with model.sharded():
                    mloss.backward()
                g = tree_map(lambda x: x.to(torch.float32), grads_of(params))
                acc = g if acc is None else tree_map(
                    lambda a, b: a.add_(b), acc, g)
                loss = loss + mloss.detach()
            grads = tree_map(lambda g: g.div_(accum_steps), acc)
            loss = loss / accum_steps
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        loss = loss.detach()
        if is_dtensor(loss):
            loss, gnorm = loss.full_tensor(), gnorm.full_tensor()
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

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
    """Shape-only stand-ins of a tree's tensors (a restore template; a
    DTensor's stand-in has its global shape)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


class TrainJob:
    """An elastic, preemptible training job — the payload a PhoenixCloud
    PBJ TRE schedules. Supports checkpoint-preempt (§5.1 adaptation):
    ``preempt()`` stops after the current step, ``checkpoint()`` saves;
    ``run()`` of a new job on the same directory restores and resumes.

    The third argument is the reference's mesh (the runtime bridge
    passes its own): a device (``None`` is the current CUDA device and
    raises without one, ``"cpu"`` the CPU) or a ``launch.mesh.Layout``;
    on a layout with a ``DeviceMesh`` the weights, the optimizer state
    and the batch are sharded by their specs and the checkpoint is
    restored onto the layout's placements (the elastic reshard).
    """

    def __init__(self, cfg: ArchConfig, job: TrainJobConfig,
                 mesh=None, compute_dtype=torch.float32):
        self.cfg = cfg
        self.jc = job
        self.mesh = mesh
        layout = mesh if hasattr(mesh, "axes") else None
        self.device = layout.device if layout is not None \
            else resolve_device(mesh)
        self.model = Model(cfg, layout if layout is not None
                           else self.device, impl="torch",
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
            sharded = self.model.mesh is not None
            specs = None
            if sharded:
                pspecs = self.model.param_specs()
                specs = {"params": pspecs,
                         "opt": self.optimizer.state_specs(pspecs)}
            state, meta = self.ckpt.restore(
                step, tpl, device=self.device,
                layout=self.mesh if sharded else None, specs=specs)
            with torch.no_grad():
                for p, saved in zip(tree_leaves(params),
                                    tree_leaves(state["params"])):
                    (p.to_local() if sharded else p).copy_(
                        saved.to_local() if sharded else saved)
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
        """The step's batch on the device; on a mesh, sharded by
        ``batch_pspecs``."""
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in self.source.batch_at(step).items()}
        if self.model.mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor
        ax = self.model.ax
        specs = batch_pspecs(self.cfg, ax)
        return {k: distribute_tensor(
            v, ax.mesh, ax.placements(ax.spec(specs[k], v.shape)),
            src_data_rank=None) for k, v in batch.items()}

    def run(self) -> Dict:
        if self.params is None:
            self.initialize()
        step_fn = make_train_step(
            self.model, self.optimizer, self.jc.accum_steps,
            grad_pspecs=self.model.param_specs()
            if self.model.mesh is not None else None)
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
