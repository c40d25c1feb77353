"""AdamW and Adafactor: the counterparts of ``repro.train.optimizer``.

The state trees keep the reference's keys, so a checkpoint names the
same leaves in both packages: ``{"mu", "nu", "count"}`` for ``adamw``,
``{"v": {…{"vr", "vc"} | {"v"}}, "count"}`` for ``adafactor``.
``state_specs`` maps the parameters' specs to the state's, as the
reference's does; on DTensor parameters (a model on a mesh) ``init``
places the state by the same rule, so each rank holds its shards.

The reference's ``update`` is functional under ``jit`` with donated
buffers. Here ``update`` works in place under ``torch.no_grad()``, one
leaf at a time: the gradient clip scales the gradients, and the step
writes the parameters and the state, so a model at gemma2-2b's width
holds no second copy of its weights. The arithmetic is the reference's,
operation for operation, in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models.common import is_dtensor, placed_zeros

__all__ = ["Optimizer", "adamw", "adafactor", "clip_by_global_norm",
           "global_norm", "get_optimizer", "tree_leaves", "tree_map"]

PyTree = Any


def tree_leaves(tree: PyTree) -> List:
    """The leaves of a nested dict, keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    # (grads, state, params, lr) → (params, state), both updated in place
    update: Callable[[PyTree, PyTree, PyTree, float], Tuple[PyTree, PyTree]]
    # The parameters' specs → the state's (the reference's state_specs).
    state_specs: Callable[[PyTree], PyTree] = None


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (a 0-d float32 tensor on the leaves' device)."""
    sq = [torch.sum(torch.square(_f32(x))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """The gradients scaled by min(1, max_norm / (norm + 1e-9)), as
    float32: a float32 leaf is scaled in place, another is copied."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: _f32(g).mul_(scale), grads)


def _zeros(shape, p: torch.Tensor, dims=None) -> torch.Tensor:
    """float32 zeros of ``shape`` on ``p``'s device. For a DTensor ``p``
    (a model on a mesh) the zeros are placed like ``p``: ``dims[i]`` is
    the dimension of ``p`` that state dimension ``i`` keeps (all of
    them by default), and a mesh axis that shards a dimension the state
    drops is replicated — the reference's ``state_specs``."""
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    dims = list(range(p.dim())) if dims is None else list(dims)
    placements = [Shard(dims.index(q.dim)) if isinstance(q, Shard)
                  and q.dim in dims else Replicate() for q in p.placements]
    return placed_zeros(shape, torch.float32, p.to_local().device,
                        p.device_mesh, placements)


def _counter(params) -> torch.Tensor:
    """The step count, int32 0; replicated over the mesh of DTensor
    parameters."""
    leaf = tree_leaves(params)[0]
    if not is_dtensor(leaf):
        return torch.zeros((), dtype=torch.int32, device=leaf.device)
    from torch.distributed.tensor import Replicate
    return placed_zeros((), torch.int32, leaf.to_local().device,
                        leaf.device_mesh,
                        [Replicate()] * leaf.device_mesh.ndim)


def _count(state) -> torch.Tensor:
    """count + 1 in place; returns it as float32."""
    state["count"].add_(1)
    return _f32(state["count"])


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: _zeros(p.shape, p)
        return {"mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params),
                "count": _counter(params)}

    @torch.no_grad()
    def update(grads, state, params, step_lr):
        grads = clip_by_global_norm(grads, max_grad_norm)
        c = _count(state)
        bc1 = 1.0 - torch.full_like(c, b1) ** c
        bc2 = 1.0 - torch.full_like(c, b2) ** c
        for g, m, v, p in zip(*(tree_leaves(t) for t in (
                grads, state["mu"], state["nu"], params))):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step.add_(weight_decay * _f32(p))
            p.copy_(_f32(p) - step_lr * step)
        return params, state

    def state_specs(pspecs):
        return {"mu": pspecs, "nu": pspecs, "count": ()}

    return Optimizer(init, update, state_specs)


def adafactor(lr: float = 1e-3, eps: float = 1e-30, decay: float = 0.8,
              max_grad_norm: float = 1.0,
              min_factored_ndim: int = 2) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018).

    Tensors with ndim >= 2 store row/col second-moment vectors instead of
    a full tensor: state is O(sum of dims), not O(numel).
    """
    def _factored(p):
        return p.ndim >= min_factored_ndim

    def init(params):
        def one(p):
            n = p.dim()
            if _factored(p):
                return {"vr": _zeros(p.shape[:-1], p, range(n - 1)),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:], p,
                                     list(range(n - 2)) + [n - 1])}
            return {"v": _zeros(p.shape, p)}
        return {"v": tree_map(one, params), "count": _counter(params)}

    @torch.no_grad()
    def update(grads, state, params, step_lr):
        grads = clip_by_global_norm(grads, max_grad_norm)
        c = _count(state)
        beta = 1.0 - c ** -decay
        for g, p, v in zip(tree_leaves(grads), tree_leaves(params),
                           _state_leaves(state["v"], params)):
            g2 = g * g + eps
            if _factored(p):
                v["vr"].mul_(beta).add_((1 - beta) * torch.mean(g2, -1))
                v["vc"].mul_(beta).add_((1 - beta) * torch.mean(g2, -2))
                denom = torch.mean(v["vr"], -1, keepdim=True)
                rfac = (v["vr"] / torch.clamp(denom, min=eps))[..., None]
                cfac = v["vc"][..., None, :]
                precond = g * torch.rsqrt(torch.clamp(rfac * cfac, min=eps))
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                precond = g * torch.rsqrt(torch.clamp(v["v"], min=eps))
            # Update clipping (RMS <= 1) as in the paper.
            rms = torch.sqrt(torch.mean(precond * precond) + 1e-30)
            precond = precond / torch.clamp(rms, min=1.0)
            p.copy_(_f32(p) - step_lr * precond)
        return params, state

    def state_specs(pspecs):
        def one(spec):
            t = tuple(spec)
            if len(t) >= min_factored_ndim:
                return {"vr": t[:-1], "vc": t[:-2] + t[-1:]}
            return {"v": t}

        return {"v": tree_map(one, pspecs), "count": ()}

    return Optimizer(init, update, state_specs)


def _state_leaves(vtree: PyTree, params: PyTree) -> List[Dict]:
    """Adafactor's per-parameter state dicts, in the parameters' leaf
    order (a state dict is a leaf here, not a subtree)."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _state_leaves(vtree[k], params[k])]
    return [vtree]


def get_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise KeyError(name)
