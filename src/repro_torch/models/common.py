"""Shared model utilities: norms, RoPE, softcap, the training loss,
initialisation and the sharding rules.

The counterparts of ``repro.models.common``.

The sharding rules (``AxisSizes``, ``shard``, ``per_rank`` and the
collective helpers) live in ``repro_torch.sharding``, below both
``models`` and ``kernels``, and are re-exported here under the
reference's module.

Where the reference computes in float32 (norms, softcap, RoPE's angles,
the loss), the port computes in ``upcast(dtype)``: float32 for bfloat16
and float32 tensors, as there, and float64 for a float64 model, so that a
float64 evaluation of the same weights is float64 throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.sharding import (  # noqa: F401  (re-exported)
    AxisSizes, all_reduce_both, all_reduce_bwd, all_reduce_fwd, assign_,
    axes_of, batch_split, contiguous_strides, entry, is_dtensor, per_rank,
    placed_empty, placed_zeros, settled, shard, split_axis, write_rows_)

__all__ = ["AxisSizes", "entry", "shard", "settled", "is_dtensor", "contiguous_strides",
           "axes_of", "split_axis", "batch_split", "per_rank",
           "all_reduce_fwd", "all_reduce_bwd", "all_reduce_both",
           "placed_empty", "placed_zeros", "assign_", "write_rows_",
           "rms_norm", "rms_norm_gated", "rope", "softcap", "normal_init",
           "KeyGen", "promote", "upcast", "cross_entropy_loss"]


def upcast(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference's float32 steps run in for ``dtype``:
    float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def promote(*xs: torch.Tensor):
    """Cast tensors to their common dtype (JAX's promotion for the
    float32 / bfloat16 mixes the models make: bf16 · f32 → f32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


# --------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6, group=None) -> torch.Tensor:
    """``group``: the last dimension is split over that group's ranks
    (per-rank code); the mean of squares is summed over it."""
    dtype = x.dtype
    x = x.to(upcast(dtype))
    if group is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        import torch.distributed as dist
        n = x.shape[-1] * dist.get_world_size(group)
        ms = all_reduce_both(torch.sum(x * x, dim=-1, keepdim=True),
                             group) / n
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + w.to(x.dtype))).to(dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6, group=None) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(z))."""
    return rms_norm(x * torch.nn.functional.silu(z.float()).to(x.dtype), w,
                    eps, group)


# ---------------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings, half-split (not interleaved). x: (..., seq,
    heads, head_dim); positions: (seq,) or (batch, seq), broadcastable to
    x's seq dim."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    ft = upcast(x.dtype)
    freqs = theta ** (-torch.arange(0, half, dtype=ft, device=x.device)
                      / half)
    angles = positions[..., None].to(ft) * freqs      # (..., seq, half)
    angles = angles[..., None, :]                      # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- init

class KeyGen:
    """The counterpart of the JAX package's key splitter: one explicit
    ``torch.Generator`` (seeded, on the device the weights are made on)
    that every initialiser draws from in turn."""

    def __init__(self, seed: int, device: Union[str, torch.device] = "cpu"):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def __call__(self) -> torch.Generator:
        return self.generator


def normal_init(gen: torch.Generator, shape: Sequence[int], stddev: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``stddev`` × a standard normal truncated at ±2, drawn in float32
    and cast to ``dtype`` (the JAX package truncates the unit normal at
    ±2 and then scales, so the bounds here are ±2·stddev)."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, mean=0.0, std=stddev, a=-2.0 * stddev,
                                b=2.0 * stddev, generator=gen)
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(upcast(x.dtype)) / cap)).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), labels (...) integer."""
    if is_dtensor(logits):
        # The vocabulary whole on each rank: DTensor's rule for a gather
        # along a sharded dimension (a masked partial) fails here.
        logits = logits.redistribute(
            placements=_unsharded_along(logits, logits.dim() - 1))
    logits = logits.to(upcast(logits.dtype))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
