"""Plain PyTorch versions of the kernels of the model path.

Straight-line implementations of what ``csrc/flash_attention.cu``,
``csrc/flash_decode.cu`` and ``csrc/ssd_scan.cu`` compute, in the
kernels' own layouts. The tests hold them against the JAX package's
Pallas kernels (interpret mode) and oracles; ``chip_smoke.py`` holds the
CUDA kernels against them on the card; the ``ops`` wrappers run them for
tensors on the CPU.

Attention (no online softmax, no blocking): scores and softmax are
float32, a masked score is ``NEG_INF`` = -2e38 (not -inf), the output
takes q's dtype. The SSD scan: ``ssd_scan_bh_ref`` is the chunked
algorithm of the Pallas kernel, chunk by chunk in float32;
``ssd_ref`` the token-by-token recurrence, the ground truth of both.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_decode_ref",
           "ssd_ref", "ssd_scan_bh_ref"]

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
    and (window) j > that position - window. A row with no visible key
    is 0."""
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
    # A masked key's weight is already exactly 0 beside a visible key;
    # zeroing it makes a row that sees no key (possible only with
    # ``q_offset``) 0, as the CUDA kernels write it, not the mean of V.
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bgst,btd->bgsd", p, v.float())
    return out.reshape(bh, sq, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (BKV, G, hd) one token per row group; k/v (BKV, S, hd); ``pos``
    the scalar write position (int or 0-d tensor). Key j is visible iff
    j <= pos, j < S and (window) j > pos - window; with no visible key
    the output is 0."""
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
    # Zero weight at invalid keys, as the Pallas kernel zeroes V there:
    # with no visible key (pos < 0, or every key left of the window) the
    # output is 0, not the mean of V; otherwise nothing changes.
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bgt,btd->bgd", p, v.float())
    return out.to(q.dtype)


def ssd_ref(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, s0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential (token-by-token) SSD recurrence, the ground truth.

    x: (BH, L, P); a: (BH, L) log-decay; B, C: (BH, L, N); s0: (BH, P,
    N). h_t = exp(a_t) h_{t-1} + x_t B_t^T; y_t = h_t C_t. Returns y in
    x's dtype and the final state h_L in float32."""
    bh, l, p = x.shape
    n = B.shape[-1]
    h = torch.zeros(bh, p, n, dtype=torch.float32, device=x.device) \
        if s0 is None else s0.float()
    a, Bf, Cf = a.float(), B.float(), C.float()
    ys = []
    for t in range(l):
        h = torch.exp(a[:, t])[:, None, None] * h \
            + x[:, t, :, None].float() * Bf[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_scan_bh_ref(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, s0: Optional[torch.Tensor] = None,
                    chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's chunked SSD scan in plain tensors, chunk by
    chunk with the (P, N) state carried across chunks, everything in
    float32. Same signature as ``ssd_scan.ssd_scan_bh``: x (BH, L, P);
    a (BH, L); B, C (BH, L, N); s0 (BH, P, N) or None. Returns y (BH, L,
    P) in x's dtype and the final state (BH, P, N) in float32.

    Per chunk: ``a_cum = cumsum(a)``; ``L[i, j] = exp(a_cum[i] -
    a_cum[j])`` for i >= j, else 0, selected (the upper triangle's
    exponent may overflow to inf, and inf * 0 would be NaN); ``y = (C
    B^T * L) x + exp(a_cum) * (C S^T)``; ``S' = S exp(a_cum[-1]) + (x *
    exp(a_cum[-1] - a_cum))^T B``."""
    bh, l, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    state = torch.zeros(bh, p, n, dtype=torch.float32, device=x.device) \
        if s0 is None else s0.float()
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, l, chunk):
        xc = x[:, c0:c0 + chunk].float()
        Bc = B[:, c0:c0 + chunk].float()
        Cc = C[:, c0:c0 + chunk].float()
        a_cum = torch.cumsum(a[:, c0:c0 + chunk].float(), dim=-1)
        L = torch.where(lower, torch.exp(a_cum[:, :, None]
                                         - a_cum[:, None, :]), zero)
        y = torch.bmm(torch.bmm(Cc, Bc.transpose(1, 2)) * L, xc)
        y = y + torch.exp(a_cum)[:, :, None] * torch.bmm(
            Cc, state.transpose(1, 2))
        ys.append(y)
        total = a_cum[:, -1:]
        w = torch.exp(total - a_cum)
        state = state * torch.exp(total)[:, :, None] + torch.bmm(
            (xc * w[:, :, None]).transpose(1, 2), Bc)
    return torch.cat(ys, dim=1).to(x.dtype), state
