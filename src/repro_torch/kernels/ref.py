"""Plain PyTorch versions of the attention kernels.

Straight-line implementations (no online softmax, no blocking) of what
``csrc/flash_attention.cu`` and ``csrc/flash_decode.cu`` compute, in the
kernels' own layouts. The tests hold them against the JAX package's
Pallas kernels (interpret mode) and oracles; ``chip_smoke.py`` holds the
CUDA kernels against them on the card; the ``ops`` wrappers run them for
tensors on the CPU. Scores and softmax are float32, a masked score is
``NEG_INF`` = -2e38 (not -inf), the output takes q's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_decode_ref"]

NEG_INF = -2.0e38


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BKV, Skv, hd), BH = BKV·G with consecutive G
    rows of q sharing one kv row. Query row i sits at absolute position
    ``q_offset + i``; key j is visible iff (causal) j <= that position
    and (window) j > that position - window."""
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    qg = q.reshape(bkv, g, sq, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgsd,btd->bgst", qg, k.float())
    s = _softcap(s, softcap)
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgst,btd->bgsd", p, v.float())
    return out.reshape(bh, sq, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (BKV, G, hd) one token per row group; k/v (BKV, S, hd); ``pos``
    the scalar write position (int or 0-d tensor). Key j is visible iff
    j <= pos, j < S and (window) j > pos - window."""
    bkv, g, hd = q.shape
    s_len = k.shape[1]
    qs = q.float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgd,btd->bgt", qs, k.float())
    s = _softcap(s, softcap)
    pos = torch.as_tensor(pos, device=q.device)
    cols = torch.arange(s_len, device=q.device)
    valid = cols <= pos
    if window is not None:
        valid &= cols > pos - window
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgt,btd->bgd", p, v.float())
    return out.to(q.dtype)
