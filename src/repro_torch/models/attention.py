"""GQA attention with KV-cache prefill / decode.

The counterpart of ``repro.models.attention``: grouped-query attention
(grouped einsum, no KV duplication), QKV bias (qwen), logit softcap and
sliding-window local layers (gemma2), and cross-attention to frontend /
encoder embeddings (vlm / audio: no mask, no rope), whose K/V are
projected once at prefill into ``ck`` / ``cv`` caches.

``impl="torch"`` is the plain tensor path (the JAX package's "xla");
``impl="cuda"`` (its "pallas") routes prefill and the full-sequence
forward through ``ops.flash_attention`` and a decode step at one scalar
position through ``ops.flash_decode``. A decode step with per-row
``(b,)`` positions (the continuous-batching ``Replica``) takes the
masked ``_sdpa_cached`` path under either impl, as in the reference.

Caches are updated in place: ``prefill_attn`` / ``decode_attn`` /
``fill_cross_cache`` write the new K/V rows into the tensors of the
``cache`` dict they are given (where the JAX functions return updated
copies) and return that dict.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import KeyGen, normal_init, promote, rope
from repro_torch.models.common import softcap as _softcap

__all__ = ["NEG_INF", "attn_shapes", "init_attn", "attend_full",
           "attend_cross", "init_cache", "prefill_attn", "decode_attn",
           "decode_cross_attn", "fill_cross_cache"]

NEG_INF = -2.0e38


def attn_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Parameter name → (shape, init stddev); biases have stddev 0."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    std = d ** -0.5
    p = {"wq": ((d, h, hd), std), "wk": ((d, k, hd), std),
         "wv": ((d, k, hd), std), "wo": ((h, hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=((h, hd), 0.0), bk=((k, hd), 0.0), bv=((k, hd), 0.0))
    return p


def init_attn(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32,
              device=None) -> Dict[str, torch.Tensor]:
    return {name: (normal_init(kg(), shape, std, dtype, device) if std
                   else torch.zeros(shape, dtype=dtype, device=device))
            for name, (shape, std) in attn_shapes(cfg).items()}


def _project_qkv(p: Dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ArchConfig, q_pos, kv_pos, use_rope: bool):
    q = torch.einsum("bsd,dhk->bshk", *promote(xq, p["wq"]))
    k = torch.einsum("btd,dmk->btmk", *promote(xkv, p["wk"]))
    v = torch.einsum("btd,dmk->btmk", *promote(xkv, p["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if use_rope:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, p: Dict) -> torch.Tensor:
    return torch.einsum("bshd,hdk->bsk", *promote(out, p["wo"]))


def _masked(scores: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return scores
    return torch.where(mask, scores,
                       torch.full((), NEG_INF, dtype=scores.dtype,
                                  device=scores.device))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ArchConfig, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention.

    q: (b, s, h, hd); k/v: (b, t, kv, hd); mask: broadcastable to
    (b, kv, g, s, t) or None.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(hd)
    scores = _masked(_softcap(scores, cfg.attn_softcap), mask)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _causal_mask(s: int, t: int, q_offset, window: Optional[int],
                 device=None) -> torch.Tensor:
    """(s, t) boolean mask; q row i sits at absolute position q_offset+i."""
    rows = torch.arange(s, device=device)[:, None] + q_offset
    cols = torch.arange(t, device=device)[None, :]
    m = cols <= rows
    if window is not None:
        m &= cols > rows - window
    return m


# Q-chunked attention: above this sequence length the full (S, S) score
# tensor would dominate device memory, so the plain path walks query
# chunks — peak temporaries drop to (b, h, CHUNK_Q, S) while the score
# work is unchanged. The flash kernel keeps no score tensor at all.
CHUNK_Q = 2048
CHUNK_THRESHOLD = 8192


def _sdpa_qchunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ArchConfig, window: Optional[int],
                   causal: bool) -> torch.Tensor:
    b, s, h, hd = q.shape
    nc = s // CHUNK_Q
    assert nc * CHUNK_Q == s, (s, CHUNK_Q)
    # Sliding-window layers only ever see a (window + CHUNK_Q) band of
    # keys per query chunk: slice it instead of scoring all s columns.
    band = min(s, window + CHUNK_Q) if (window and causal) else None
    outs = []
    for ci in range(nc):
        qi = q[:, ci * CHUNK_Q:(ci + 1) * CHUNK_Q]
        if band is not None and band < s:
            start = min(max(ci * CHUNK_Q + CHUNK_Q - band, 0), s - band)
            rows = ci * CHUNK_Q + torch.arange(CHUNK_Q, device=q.device)[:, None]
            cols = start + torch.arange(band, device=q.device)[None, :]
            mask = (cols <= rows) & (cols > rows - window)
            outs.append(_sdpa(qi, k[:, start:start + band],
                              v[:, start:start + band], cfg, mask))
        else:
            mask = _causal_mask(CHUNK_Q, s, ci * CHUNK_Q, window,
                                q.device) if causal else None
            outs.append(_sdpa(qi, k, v, cfg, mask))
    return torch.cat(outs, dim=1)


def _sdpa_auto(q, k, v, cfg, window, causal):
    s = q.shape[1]
    if s > CHUNK_THRESHOLD and s % CHUNK_Q == 0:
        return _sdpa_qchunked(q, k, v, cfg, window, causal)
    mask = _causal_mask(s, k.shape[1], 0, window, q.device) if causal \
        else None
    return _sdpa(q, k, v, cfg, mask)


def attend_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, local: bool,
                impl: str = "torch", causal: bool = True) -> torch.Tensor:
    """Training / prefill self-attention over the whole sequence.
    ``causal=False`` gives the bidirectional encoder variant."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg, pos, pos, use_rope=True)
    window = cfg.sliding_window if local else None
    if impl == "cuda" and causal:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap)
    else:
        out = _sdpa_auto(q, k, v, cfg, window, causal)
    return _out_proj(out, p)


def attend_cross(p: Dict, x: torch.Tensor, src: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Cross-attention to frontend / encoder embeddings ``src`` (b, F, d):
    no mask, no rope."""
    q, k, v = _project_qkv(p, x, src, cfg, None, None, use_rope=False)
    return _out_proj(_sdpa(q, k, v, cfg, mask=None), p)


# ------------------------------------------------------------------ caching
#
# Cache layout is (batch, kv_heads, seq, head_dim), decode-native: the
# per-token attention reads K/V with (b, kv) as batch dims and contracts
# over head_dim with no transpose; prefill pays one transpose when
# filling.

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               cross_len: int = 0, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-attention-layer cache template (used stacked over periods);
    ``cross_len`` adds the cross-attention K/V ``ck`` / ``cv``."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    lengths = {"k": max_len, "v": max_len}
    if cross_len:
        lengths.update(ck=cross_len, cv=cross_len)
    return {name: torch.zeros(batch, kv, t, hd, dtype=dtype, device=device)
            for name, t in lengths.items()}


def _sdpa_cached(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cfg: ArchConfig,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Decode attention against the (b, kv, t, hd) cache layout.

    q: (b, s, H, hd) with tiny s (1 for decode); mask broadcastable to
    (b, kv, g, s, t) or None. The cache is not transposed.
    """
    b, s, h, hd = q.shape
    kv = k_cache.shape[1]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4)   # tiny
    scores = torch.einsum("bkgsd,bktd->bkgst", qg,
                          k_cache.to(q.dtype)) / math.sqrt(hd)
    scores = _masked(_softcap(scores, cfg.attn_softcap), mask)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v_cache.to(q.dtype))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def prefill_attn(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                 local: bool, impl: str = "torch"
                 ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also fills the KV cache (rows
    ``[0, s)``, in place)."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg, pos, pos, use_rope=True)
    window = cfg.sliding_window if local else None
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap)
    else:
        out = _sdpa_auto(q, k, v, cfg, window, causal=True)
    # One transpose into the decode-native (b, kv, t, hd) layout.
    cache["k"][:, :, :s] = k.permute(0, 2, 1, 3)
    cache["v"][:, :, :s] = v.permute(0, 2, 1, 3)
    return _out_proj(out, p), cache


def decode_attn(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                pos: Union[int, torch.Tensor], local: bool,
                impl: str = "torch") -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the (b, kv, t, hd) cache. x: (b, 1, d).

    ``pos`` is either a scalar, one write position shared by every batch
    row, or per-row ``(b,)`` for continuous batching, where the rows sit
    at heterogeneous sequence positions (the serving engine's slots).
    Per-row positions rotate, write and mask each row at its own
    position and take the masked ``_sdpa_cached`` path (the flash-decode
    kernel contracts on a scalar position, as in the reference). The
    write index is ``min(pos, max_len - 1)``, computed on the device.
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long()
    max_len = cache["k"].shape[2]
    window = cfg.sliding_window if local else None
    at = torch.clamp(pos, max=max_len - 1)
    if pos.dim() == 0:
        q, k_new, v_new = _project_qkv(p, x, x, cfg, pos[None], pos[None],
                                       use_rope=True)
        cache["k"].index_copy_(2, at.reshape(1),
                               k_new.permute(0, 2, 1, 3).to(cache["k"].dtype))
        cache["v"].index_copy_(2, at.reshape(1),
                               v_new.permute(0, 2, 1, 3).to(cache["v"].dtype))
        if impl == "cuda":
            from repro_torch.kernels import ops as kops
            out = kops.flash_decode(q, cache["k"], cache["v"], at,
                                    window=window, softcap=cfg.attn_softcap)
            return _out_proj(out, p), cache
        cols = torch.arange(max_len, device=x.device)
        valid = cols <= at
        if window is not None:
            valid &= cols > at - window
        mask = valid[None, None, None, None, :]      # (b,kv,g,1,t)
    else:
        q, k_new, v_new = _project_qkv(p, x, x, cfg, pos[:, None],
                                       pos[:, None], use_rope=True)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, :, at, :] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, :, at, :] = v_new[:, 0].to(cache["v"].dtype)
        cols = torch.arange(max_len, device=x.device)[None, :]
        valid = cols <= at[:, None]
        if window is not None:
            valid &= cols > at[:, None] - window
        mask = valid[:, None, None, None, :]         # (b,kv,g,1,t)
    out = _sdpa_cached(q, cache["k"], cache["v"], cfg, mask)
    return _out_proj(out, p), cache


def decode_cross_attn(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      cache: Dict) -> torch.Tensor:
    """Cross-attention during decode: K/V read from the ``ck`` / ``cv``
    cache that ``fill_cross_cache`` wrote at prefill."""
    q = torch.einsum("bsd,dhk->bshk", *promote(x, p["wq"]))
    if cfg.qkv_bias:
        q = q + p["bq"]
    return _out_proj(_sdpa_cached(q, cache["ck"], cache["cv"], cfg,
                                  mask=None), p)


def fill_cross_cache(p: Dict, src: torch.Tensor, cfg: ArchConfig,
                     cache: Dict) -> Dict:
    """Project ``src`` (b, F, d) to K/V and write them, in the cache's
    dtype and the decode-native layout, over ``cache["ck"]`` /
    ``cache["cv"]`` (in place)."""
    k = torch.einsum("btd,dmk->btmk", *promote(src, p["wk"]))
    v = torch.einsum("btd,dmk->btmk", *promote(src, p["wv"]))
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    cache["ck"].copy_(k.permute(0, 2, 1, 3))
    cache["cv"].copy_(v.permute(0, 2, 1, 3))
    return cache
