"""Gradient compression over slow links — the int8 error-feedback
all-reduce: the counterpart of ``repro.train.compression``.

At multi-pod scale the per-step gradient all-reduce crosses the
inter-pod links once; those links are the slowest in the system. This
module is a ring all-reduce whose gather leg is int8 on the wire:

  1. error feedback:  y = g + e   (the residual of the previous step)
  2. shared scale:    s = max|y| / 127   (a MAX all-reduce over the axis)
  3. quantize to int8, ring reduce-scatter (K−1 ring steps, accumulated
     in int32), requantize the reduced chunk to int8, ring all-gather
  4. new residual:    e' = y − dequantized(q)

Error feedback makes the quantization bias vanish over steps
(Karimireddy et al., 2019).

The reference runs these inside ``shard_map`` with a named axis; here
they are per-rank code over one axis's process group
(``DeviceMesh.get_group(name)``; ``None`` is the default group), and
each ``ppermute`` is one ``batch_isend_irecv`` step of the ring: rank
``i`` sends to ``i + 1`` and receives from ``i − 1``. The reduce-scatter
leg sends its int32 partial sums, as the reference's ``ppermute`` of its
int32 accumulator does; the gather leg sends int8. The arithmetic is the
reference's, in its order: ``round`` is half-to-even in both, and
``y / scale`` is a division.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_map

__all__ = ["quantize_int8", "ring_reduce_scatter_int8", "ring_all_gather",
           "ef_allreduce_mean", "ef_allreduce_tree", "init_error_state"]

Group = Optional[dist.ProcessGroup]


def _axis(group: Group) -> Tuple[int, int]:
    """(size, this rank's index) of the axis."""
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_step(x: torch.Tensor, group: Group) -> torch.Tensor:
    """One ring step (the reference's ``ppermute`` with ``perm = [(i, i+1
    mod K)]``): sends ``x`` to the next rank, returns the previous
    rank's."""
    k, idx = _axis(group)
    nxt = dist.get_global_rank(group, (idx + 1) % k) if group is not None \
        else (idx + 1) % k
    prv = dist.get_global_rank(group, (idx - 1) % k) if group is not None \
        else (idx - 1) % k
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def quantize_int8(y: torch.Tensor, group: Group = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with a scale shared over the axis
    (the MAX all-reduce of each rank's ``max|y|``)."""
    amax = y.abs().max().clone()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale


def ring_reduce_scatter_int8(q: torch.Tensor, group: Group = None
                             ) -> torch.Tensor:
    """Ring reduce-scatter of int8 chunks with int32 accumulation.

    ``q``: (K·C,) int8 on each of K ranks → this rank's (C,) int32
    reduced chunk. Rank ``s`` finishes holding chunk ``(s + 1) mod K``.
    """
    k, idx = _axis(group)
    if k == 1:
        return q.to(torch.int32)
    chunks = q.reshape(k, -1)
    # Each rank starts by sending its own chunk; after step i it holds
    # the partial sum of chunk (idx - i - 1) mod k.
    send = chunks[idx].to(torch.int32)
    acc = send
    for i in range(k - 1):
        send = _ring_step(send, group)
        acc = send + chunks[(idx - i - 1) % k].to(torch.int32)
        send = acc
    return acc


def ring_all_gather(x: torch.Tensor, group: Group = None,
                    shift: int = 0) -> torch.Tensor:
    """Ring all-gather (K−1 ring steps) → (K, *x.shape).

    Piece j arriving at this rank originated at rank ``(idx - j) mod
    K``; it is placed at slot ``(origin + shift) mod K``. ``shift=1``
    matches the chunk → rank map of :func:`ring_reduce_scatter_int8`.
    """
    k, idx = _axis(group)
    if k == 1:
        return x[None]
    pieces = [x]
    cur = x
    for _ in range(k - 1):
        cur = _ring_step(cur, group)
        pieces.append(cur)
    stacked = torch.stack(pieces)                  # [me, me-1, me-2, ...]
    order = (idx - torch.arange(k) + shift) % k
    out = torch.zeros_like(stacked)
    out[order.to(stacked.device)] = stacked
    return out


def ef_allreduce_mean(g: torch.Tensor, err: torch.Tensor,
                      group: Group = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean all-reduce of one tensor over the axis.

    Returns ``(mean_g, new_err)`` in float32, of ``g``'s shape; the
    tensor is padded to a multiple of ``K · 128`` inside."""
    k, _ = _axis(group)
    shape = g.shape
    y = g.to(torch.float32) + err
    q, scale = quantize_int8(y, group)
    flat = q.reshape(-1)
    pad = (-flat.numel()) % (k * 128)
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunk = ring_reduce_scatter_int8(flat, group)          # (C,) int32
    # Requantize the reduced chunk to int8 for the gather leg.
    cmax = chunk.abs().max().to(torch.float32)
    dist.all_reduce(cmax, op=dist.ReduceOp.MAX, group=group)
    cscale = torch.clamp_min(cmax, 1.0) / 127.0
    cq = torch.clamp(torch.round(chunk.to(torch.float32) / cscale),
                     -127, 127).to(torch.int8)
    gathered = ring_all_gather(cq, group, shift=1).reshape(-1)
    summed = gathered.to(torch.float32) * cscale * scale
    summed = summed[:y.numel()].reshape(shape)
    mean = summed / k
    # The residual: what this rank failed to communicate.
    new_err = y - q.to(torch.float32) * scale
    return mean, new_err


def ef_allreduce_tree(grads: Any, errs: Any, group: Group = None):
    """:func:`ef_allreduce_mean` leaf by leaf over a gradient tree (a
    nested dict); the means keep each gradient's dtype."""
    pairs = tree_map(lambda g, e: ef_allreduce_mean(g, e, group), grads,
                     errs)
    return (_pick(pairs, 0, grads), _pick(pairs, 1, None))


def _pick(tree, i: int, like):
    if isinstance(tree, dict):
        return {k: _pick(v, i, like[k] if like is not None else None)
                for k, v in tree.items()}
    out = tree[i]
    return out.to(like.dtype) if like is not None else out


def init_error_state(params: Any) -> Dict:
    """Zero float32 residuals of the parameters' shapes."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
