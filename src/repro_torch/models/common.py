"""Shared model utilities: norms, RoPE, softcap and initialisation.

The counterparts of ``repro.models.common``. The JAX module's sharding
helpers (``AxisSizes``, ``shard``) have no counterpart: the port runs a
model on one card (the device mesh is ROADMAP A3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["rms_norm", "rms_norm_gated", "rope", "softcap", "normal_init",
           "KeyGen", "promote"]


def promote(*xs: torch.Tensor):
    """Cast tensors to their common dtype (JAX's promotion for the
    float32 / bfloat16 mixes the models make: bf16 · f32 → f32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


# --------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(z))."""
    return rms_norm(x * torch.nn.functional.silu(z.float()).to(x.dtype), w,
                    eps)


# ---------------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings, half-split (not interleaved). x: (..., seq,
    heads, head_dim); positions: (seq,) or (batch, seq), broadcastable to
    x's seq dim."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs     # (..., seq, half)
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
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
