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
from repro_torch.models.common import (AxisSizes, KeyGen, assign_, axes_of,
                                       batch_split, is_dtensor, normal_init,
                                       per_rank, promote, rope, split_axis,
                                       upcast, write_rows_)
from repro_torch.models.common import softcap as _softcap

__all__ = ["NEG_INF", "attn_shapes", "attn_specs", "init_attn", "attend_full",
           "attend_cross", "cache_shapes", "init_cache", "prefill_attn", "decode_attn",
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


def attn_specs(cfg: ArchConfig, ax: AxisSizes) -> Dict:
    """The reference's parameter specs of one attention layer."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = {
        "wq": ax.spec(("data", "model", None), (d, h, hd)),
        "wk": ax.spec(("data", "model", None), (d, k, hd)),
        "wv": ax.spec(("data", "model", None), (d, k, hd)),
        "wo": ax.spec(("model", None, "data"), (h, hd, d)),
    }
    if cfg.qkv_bias:
        s["bq"] = ax.spec(("model", None), (h, hd))
        s["bk"] = ax.spec(("model", None), (k, hd))
        s["bv"] = ax.spec(("model", None), (k, hd))
    return s


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
    probs = torch.softmax(scores.to(upcast(scores.dtype)),
                          dim=-1).to(q.dtype)
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


# ------------------------------------------------------ per rank on a mesh
#
# On DTensors each attention function runs per rank (``common.per_rank``):
# the rows over the batch axes, the heads over "model" where the kv
# heads divide it (query heads then divide too, and each rank keeps whole
# GQA groups), everything else whole. The weights' "data" sharding is
# all-gathered at use, and the output projection's result is each rank's
# partial sum over "model". DTensor's own rules for the projections'
# einsums fail on the (b·s)-folded views of large cells.

_HEADS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}


def _split(x, cfg: ArchConfig):
    ax = axes_of(x)
    return ax, batch_split(ax, x.shape[0]), split_axis(ax, cfg.n_kv_heads)


def _weight_dims(p: Dict, names, hx):
    return [tuple(hx if i == _HEADS[n] else None
                  for i in range(p[n].dim())) for n in names]


def _with_weights(fn, p: Dict, names):
    """``fn(*tensors, p_local)`` from ``(*tensors, *weights)``."""
    k = len(names)
    return lambda *a: fn(*a[:-k], dict(zip(names, a[-k:]))) if k else \
        fn(*a, {})


def _qkv_names(cfg: ArchConfig, which: str = "qkv"):
    out = [f"w{c}" for c in which]
    if cfg.qkv_bias:
        out += [f"b{c}" for c in which]
    return out


def _project_per_rank(p, x, cfg, pos, use_rope=True, src=None):
    """q, k, v DTensors (rows over the batch axes, heads over "model"),
    projected per rank; k / v from ``src`` when given."""
    ax, bt, hx = _split(x, cfg)
    names = _qkv_names(cfg)
    kv_in = x if src is None else src

    def body(xq, xkv, w):
        return _project_qkv(w, xq, xkv, cfg, pos, pos, use_rope)

    head = (bt, None, hx, None)
    return per_rank(_with_weights(body, p, names), ax,
                    (x, kv_in, *[p[n] for n in names]),
                    [(bt, None, None)] * 2 + _weight_dims(p, names, hx),
                    [head] * 3)


def _out_per_rank(fn, p, x, cfg, tensors, dims):
    """``_out_proj(fn(*local tensors), wo)`` per rank: each rank's
    partial sum over "model" where the heads are split."""
    ax, bt, hx = _split(x, cfg)

    def body(*a):
        *t, w = a
        return _out_proj(fn(*t), {"wo": w})

    return per_rank(body, ax, (*tensors, p["wo"]),
                    list(dims) + _weight_dims(p, ["wo"], hx),
                    [(bt, None, None)], partial=[hx])


def attend_full(p: Dict, x: torch.Tensor, cfg: ArchConfig, local: bool,
                impl: str = "torch", causal: bool = True) -> torch.Tensor:
    """Training / prefill self-attention over the whole sequence.
    ``causal=False`` gives the bidirectional encoder variant."""
    if is_dtensor(x):
        ax, bt, hx = _split(x, cfg)
        names = sorted(p)
        return per_rank(
            _with_weights(lambda x_, w: attend_full(w, x_, cfg, local, impl,
                                                    causal), p, names),
            ax, (x, *[p[n] for n in names]),
            [(bt, None, None)] + _weight_dims(p, names, hx),
            [(bt, None, None)], partial=[hx])
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
    if is_dtensor(x):
        ax, bt, hx = _split(x, cfg)
        names = sorted(p)
        return per_rank(
            _with_weights(lambda x_, s_, w: attend_cross(w, x_, s_, cfg), p,
                          names),
            ax, (x, src, *[p[n] for n in names]),
            [(bt, None, None)] * 2 + _weight_dims(p, names, hx),
            [(bt, None, None)], partial=[hx])
    q, k, v = _project_qkv(p, x, src, cfg, None, None, use_rope=False)
    return _out_proj(_sdpa(q, k, v, cfg, mask=None), p)


# ------------------------------------------------------------------ caching
#
# Cache layout is (batch, kv_heads, seq, head_dim), decode-native: the
# per-token attention reads K/V with (b, kv) as batch dims and contracts
# over head_dim with no transpose; prefill pays one transpose when
# filling.

def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 cross_len: int = 0) -> Dict[str, Tuple[int, ...]]:
    """The shapes of ``init_cache``'s tensors."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    lengths = {"k": max_len, "v": max_len}
    if cross_len:
        lengths.update(ck=cross_len, cv=cross_len)
    return {name: (batch, kv, t, hd) for name, t in lengths.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               cross_len: int = 0, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-attention-layer cache template (used stacked over periods);
    ``cross_len`` adds the cross-attention K/V ``ck`` / ``cv``."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_shapes(cfg, batch, max_len,
                                            cross_len).items()}


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
    probs = torch.softmax(scores.to(upcast(scores.dtype)),
                          dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v_cache.to(q.dtype))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def prefill_attn(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                 local: bool, impl: str = "torch"
                 ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also fills the KV cache (rows
    ``[0, s)``, in place)."""
    window = cfg.sliding_window if local else None
    if is_dtensor(x):
        pos = torch.arange(x.shape[1], device=x.device)
        q, k, v = _project_per_rank(p, x, cfg, pos)
        write_rows_(cache["k"], k.permute(0, 2, 1, 3), 0)
        write_rows_(cache["v"], v.permute(0, 2, 1, 3), 0)

        def attend(q_, k_, v_):
            if impl == "cuda":
                from repro_torch.kernels import ops as kops
                return kops.flash_attention(q_, k_, v_, causal=True,
                                            window=window,
                                            softcap=cfg.attn_softcap)
            return _sdpa_auto(q_, k_, v_, cfg, window, causal=True)

        _, bt, hx = _split(x, cfg)
        return _out_per_rank(attend, p, x, cfg, (q, k, v),
                             [(bt, None, hx, None)] * 3), cache
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
    if is_dtensor(cache["k"]):
        write_rows_(cache["k"], k.permute(0, 2, 1, 3), 0)
        write_rows_(cache["v"], v.permute(0, 2, 1, 3), 0)
    else:
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
    if is_dtensor(x):
        if pos.dim() != 0:
            raise NotImplementedError(
                "per-row decode positions on a mesh: the serving engine's "
                "slots run on one device")
        q, k_new, v_new = _project_per_rank(p, x, cfg, pos[None])
        write_rows_(cache["k"], k_new.permute(0, 2, 1, 3), at)
        write_rows_(cache["v"], v_new.permute(0, 2, 1, 3), at)

        def read(q_, kc, vc):
            if impl == "cuda":
                from repro_torch.kernels import ops as kops
                return kops.flash_decode(q_, kc, vc, at, window=window,
                                         softcap=cfg.attn_softcap)
            cols = torch.arange(max_len, device=q_.device)
            valid = cols <= at
            if window is not None:
                valid &= cols > at - window
            return _sdpa_cached(q_, kc, vc, cfg,
                                valid[None, None, None, None, :])

        _, bt, hx = _split(x, cfg)
        return _out_per_rank(read, p, x, cfg, (q, cache["k"], cache["v"]),
                             [(bt, None, hx, None), (bt, hx, None, None),
                              (bt, hx, None, None)]), cache
    if pos.dim() == 0:
        q, k_new, v_new = _project_qkv(p, x, x, cfg, pos[None], pos[None],
                                       use_rope=True)
        write_rows_(cache["k"], k_new.permute(0, 2, 1, 3), at)
        write_rows_(cache["v"], v_new.permute(0, 2, 1, 3), at)
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
    if is_dtensor(x):
        ax, bt, hx = _split(x, cfg)
        names = _qkv_names(cfg, "q") + ["wo"]
        return per_rank(
            _with_weights(lambda x_, ck, cv, w: decode_cross_attn(
                w, x_, cfg, {"ck": ck, "cv": cv}), p, names),
            ax, (x, cache["ck"], cache["cv"], *[p[n] for n in names]),
            [(bt, None, None)] + [(bt, hx, None, None)] * 2
            + _weight_dims(p, names, hx),
            [(bt, None, None)], partial=[hx])
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
    if is_dtensor(src):
        ax, bt, hx = _split(src, cfg)
        names = _qkv_names(cfg, "kv")

        def body(s_, w):
            k_ = torch.einsum("btd,dmk->btmk", *promote(s_, w["wk"]))
            v_ = torch.einsum("btd,dmk->btmk", *promote(s_, w["wv"]))
            if cfg.qkv_bias:
                k_, v_ = k_ + w["bk"], v_ + w["bv"]
            return k_, v_

        k, v = per_rank(_with_weights(body, p, names), ax,
                        (src, *[p[n] for n in names]),
                        [(bt, None, None)] + _weight_dims(p, names, hx),
                        [(bt, None, hx, None)] * 2)
        assign_(cache["ck"], k.permute(0, 2, 1, 3))
        assign_(cache["cv"], v.permute(0, 2, 1, 3))
        return cache
    k = torch.einsum("btd,dmk->btmk", *promote(src, p["wk"]))
    v = torch.einsum("btd,dmk->btmk", *promote(src, p["wv"]))
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    assign_(cache["ck"], k.permute(0, 2, 1, 3))
    assign_(cache["cv"], v.permute(0, 2, 1, 3))
    return cache
