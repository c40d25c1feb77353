"""Gated MLP: the counterpart of ``repro.models.mlp`` for dense layers.

The products are plain ``torch.matmul`` calls, as the JAX package left
them to XLA outside any Pallas kernel. The Mixture-of-Experts layer is
not ported yet: ``Model`` raises for MoE configs (ROADMAP, queued work
of the port).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import KeyGen, normal_init, promote

__all__ = ["dense_mlp_shapes", "init_dense_mlp", "dense_mlp"]


def dense_mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                         float]]:
    """Parameter name → (shape, init stddev)."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": ((d, f), d ** -0.5), "w3": ((d, f), d ** -0.5),
            "w2": ((f, d), f ** -0.5)}


def init_dense_mlp(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    return {name: normal_init(kg(), shape, std, dtype, device)
            for name, (shape, std) in dense_mlp_shapes(cfg).items()}


def dense_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    a, w1 = promote(x, p["w1"])
    h = torch.nn.functional.silu(a @ w1) * (a @ p["w3"].to(a.dtype))
    return torch.matmul(*promote(h, p["w2"]))

