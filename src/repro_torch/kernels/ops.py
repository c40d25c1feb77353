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
which is what the CPU tests reach through ``Model(impl="cuda")``. On
meta tensors (the dry run) each allocates what the CUDA wrapper
allocates, its output and scratch, and reports the kernel's FLOPs and
bytes (``cost.report``) in place of a launch; flash decode, which cannot
read a meta position, counts every key of the cache (within the window)
as visible.

On DTensors (a model on a mesh) each entry point runs per rank through
``sharding.per_rank``: the batch over the batch axes (``"pod"``,
``"data"``) and the heads over ``"model"`` where they divide, everything
else whole.
Inputs placed otherwise are redistributed first, as GSPMD would; the
sequence of a batch-1 cache sharded over ``"data"`` is all-gathered
before flash decode, which reads every key of a row.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels import flash_decode as fdk
from repro_torch.kernels.flash_attention import flash_attention_bkv
from repro_torch.kernels.flash_decode import flash_decode_bkv
from repro_torch.kernels.ssd_scan import ssd_scan_bh
from repro_torch.sharding import (axes_of, batch_split, is_dtensor, per_rank,
                                  split_axis)

__all__ = ["flash_attention", "flash_decode", "fold_ssd", "ssd"]


def _specs(x: torch.Tensor, heads: int):
    """(the mesh axes of DTensor ``x``, the batch entry, the heads entry):
    the batch over the batch axes and the heads over ``"model"`` where
    ``x``'s batch and ``heads`` (the kv heads) divide them."""
    ax = axes_of(x)
    return ax, batch_split(ax, x.shape[0]), split_axis(ax, heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (b, s, h, hd); k/v (b, s, kv, hd) → (b, s, h, hd)."""
    if is_dtensor(q):
        ax, bt, hx = _specs(q, k.shape[2])
        spec = (bt, None, hx, None)
        return per_rank(lambda *t: flash_attention(
            *t, causal=causal, window=window, softcap=softcap), ax,
            (q, k, v), [spec] * 3, [spec])
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    # (b, s, kv, g, hd) → (b*kv*g, s, hd); consecutive g rows share a kv head.
    qk = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b * kv * g, s, hd).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(b * kv, k.shape[1], hd).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(b * kv, v.shape[1], hd).contiguous()
    if q.device.type == "meta":
        out = torch.empty_like(qk)
        cost.report("flash_attention", *cost.attention_cost(qk, kk, window,
                                                            causal))
    else:
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
    if is_dtensor(q):
        ax, bt, hx = _specs(q, k_cache.shape[1])
        cache = (bt, hx, None, None)
        return per_rank(lambda *t: flash_decode(
            *t, window=window, softcap=softcap), ax,
            (q, k_cache, v_cache, pos),
            [(bt, None, hx, None), cache, cache, None],
            [(bt, None, hx, None)])
    b, _, h, hd = q.shape
    kv = k_cache.shape[1]
    g = h // kv
    qf = q.reshape(b * kv, g, hd).contiguous()
    kf = k_cache.reshape(b * kv, k_cache.shape[2], hd)
    vf = v_cache.reshape(b * kv, v_cache.shape[2], hd)
    if q.device.type == "meta":
        out = _meta_decode(qf, kf, pos, window)
    else:
        fn = flash_decode_bkv if q.device.type == "cuda" \
            else ref.flash_decode_ref
        out = fn(qf, kf, vf, pos, window=window, softcap=softcap)
    return out.reshape(b, 1, h, hd)


def _meta_decode(q: torch.Tensor, k: torch.Tensor, pos,
                 window: Optional[int]) -> torch.Tensor:
    """``flash_decode_bkv``'s allocations on meta tensors: its int32
    position, the split-K partials and the output."""
    torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    s = k.shape[1]
    nb = fdk.runs(q.device, q.shape[0],
                  -(-s // fdk.chunk_keys(k.dtype, q.shape[2])))
    partials = fdk.partials(q, nb)
    out = torch.empty_like(q)
    visible = s if window is None else min(window, s)
    cost.report("flash_decode", *cost.decode_cost(q, k, visible))
    del partials
    return out


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
    if is_dtensor(x):
        ax, bt, hx = _specs(x, x.shape[2])
        args = (x, a, B, C) + ((init_state,) if init_state is not None
                               else ())
        state = (bt, hx, None, None)
        dims = [(bt, None, hx, None), (bt, None, hx),
                (bt, None, None, None), (bt, None, None, None), state]
        return per_rank(lambda *t: ssd(
            *t[:4], init_state=t[4] if len(t) > 4 else None, chunk=chunk),
            ax, args, dims[:len(args)], [(bt, None, hx, None), state])
    b, l, h, p = x.shape
    xf, af, Bh, Ch, s0 = fold_ssd(x, a, B, C, init_state)
    if x.device.type == "meta":
        y, sT = _meta_ssd(xf, af, Bh, Ch, s0, chunk)
    else:
        fn = ssd_scan_bh if x.device.type == "cuda" else ref.ssd_scan_bh_ref
        y, sT = fn(xf, af, Bh, Ch, s0=s0, chunk=chunk)
    return (y.reshape(b, h, l, p).permute(0, 2, 1, 3),
            sT.reshape(b, h, p, B.shape[3]))


def _meta_ssd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, s0: Optional[torch.Tensor], chunk: int):
    """``ssd_scan_bh``'s allocations on meta tensors: float32 copies of
    ``a`` and ``s0`` where they are not float32 already, y and the final
    state."""
    chunk = min(chunk, x.shape[1])
    a = a.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    bh, _, p = x.shape
    y = torch.empty_like(x)
    sT = torch.empty(bh, p, B.shape[-1], dtype=torch.float32,
                     device=x.device)
    cost.report("ssd_scan", *cost.ssd_cost(x, a, B, C, chunk,
                                           s0 is not None))
    return y, sT
