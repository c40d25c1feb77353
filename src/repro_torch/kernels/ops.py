"""Model-layout entry points of the model kernels.

The counterparts of ``repro.kernels.ops``: ``flash_attention`` over
(b, s, h, hd) tensors, ``flash_decode`` over the decode-native
(b, kv, s, hd) cache and ``ssd`` over (b, l, h, p) tensors with grouped
B / C, folded into the kernels' layouts exactly as the JAX package folds
them (consecutive G = h / kv query heads share one kv head; B / C groups
repeated to heads, batch × heads folded). On CUDA tensors they launch
the CUDA kernels (``flash_attention.flash_attention_bkv``,
``flash_decode.flash_decode_bkv``, ``ssd_scan.ssd_scan_bh``); on CPU
tensors, and only there, they run the kernels' plain versions (``ref``),
which is what the CPU tests reach through ``Model(impl="cuda")``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bkv
from repro_torch.kernels.flash_decode import flash_decode_bkv
from repro_torch.kernels.ssd_scan import ssd_scan_bh

__all__ = ["flash_attention", "flash_decode", "fold_ssd", "ssd"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (b, s, h, hd); k/v (b, s, kv, hd) → (b, s, h, hd)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    # (b, s, kv, g, hd) → (b*kv*g, s, hd); consecutive g rows share a kv head.
    qk = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b * kv * g, s, hd).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(b * kv, k.shape[1], hd).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(b * kv, v.shape[1], hd).contiguous()
    fn = flash_attention_bkv if q.device.type == "cuda" \
        else ref.flash_attention_ref
    out = fn(qk, kk, vk, causal=causal, window=window, softcap=softcap)
    return out.reshape(b, kv, g, s, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, s, h, hd)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: Union[int, torch.Tensor], *,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """Serving layout: q (b, 1, h, hd); k/v cache (b, kv, s, hd); pos a
    scalar (int or 0-d tensor). Returns (b, 1, h, hd)."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[1]
    g = h // kv
    qf = q.reshape(b * kv, g, hd).contiguous()
    kf = k_cache.reshape(b * kv, k_cache.shape[2], hd)
    vf = v_cache.reshape(b * kv, v_cache.shape[2], hd)
    fn = flash_decode_bkv if q.device.type == "cuda" \
        else ref.flash_decode_ref
    out = fn(qf, kf, vf, pos, window=window, softcap=softcap)
    return out.reshape(b, 1, h, hd)


def fold_ssd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, init_state: Optional[torch.Tensor] = None):
    """The model layout folded into the SSD kernel's: x (b, l, h, p), a
    (b, l, h), B/C (b, l, g, n), init_state (b, h, p, n) → x (b·h, l, p),
    a (b·h, l), B/C (b·h, l, n) (each group's copy per head), s0
    (b·h, p, n) in float32 or None."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2).permute(0, 2, 1, 3) \
        .reshape(b * h, l, n).contiguous()
    Ch = torch.repeat_interleave(C, rep, dim=2).permute(0, 2, 1, 3) \
        .reshape(b * h, l, n).contiguous()
    xf = x.permute(0, 2, 1, 3).reshape(b * h, l, p).contiguous()
    af = a.permute(0, 2, 1).reshape(b * h, l).contiguous()
    s0 = None if init_state is None else \
        init_state.reshape(b * h, p, n).float()
    return xf, af, Bh, Ch, s0


def ssd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        *, init_state: Optional[torch.Tensor] = None,
        chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (b, l, h, p); a (b, l, h); B/C (b, l, g, n);
    init_state (b, h, p, n). Returns (y (b, l, h, p), state (b, h, p, n)
    in float32)."""
    b, l, h, p = x.shape
    xf, af, Bh, Ch, s0 = fold_ssd(x, a, B, C, init_state)
    fn = ssd_scan_bh if x.device.type == "cuda" else ref.ssd_scan_bh_ref
    y, sT = fn(xf, af, Bh, Ch, s0=s0, chunk=chunk)
    return (y.reshape(b, h, l, p).permute(0, 2, 1, 3),
            sT.reshape(b, h, p, B.shape[3]))
