"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060.

The counterpart of ``repro.models.mamba2``. Prefill runs the chunked SSD
algorithm (quadratic within chunks, linear across chunks); decode is the
O(1) recurrent state update, plain tensor code under either impl, as in
the reference.

``impl="torch"`` is the plain chunked path (the JAX package's "xla");
``impl="cuda"`` (its "pallas") runs the scan through ``ops.ssd``: the
CUDA kernel on CUDA tensors, its plain version on CPU tensors.

The JAX package mixes bfloat16 activations with float32 parameters and
caches and lets JAX promote (bf16 · f32 → f32); the port promotes
explicitly (``common.promote``) and matches the reference's dtype at each
step. The caches are float32 whatever the compute dtype, as in the
reference, and are updated in place: ``mamba_prefill`` / ``mamba_decode``
copy the new ``state``, ``conv_x`` and ``conv_bc`` into the tensors of
the cache dict they are given (where the JAX functions return new
dicts). A prompt shorter than the conv window's ``ssm_conv - 1`` tokens
is refused (the reference's prefill then emits a conv cache of the wrong
length).

The JAX module's sharding specs (``mamba_specs``, ``mamba_cache_specs``)
have no counterpart: the port runs a model on one card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (AxisSizes, KeyGen, assign_, axes_of,
                                       batch_split, is_dtensor, normal_init,
                                       per_rank, promote, rms_norm_gated,
                                       split_axis)

__all__ = ["CHUNK", "N_GROUPS", "F32_PARAMS", "dims", "mamba_shapes",
           "mamba_specs",
           "init_mamba", "ssd_chunked", "mamba_full", "mamba_cache_shapes",
           "init_mamba_cache",
           "mamba_prefill", "mamba_decode"]

CHUNK = 128
N_GROUPS = 1    # B/C projection groups (mamba2 default)
# Parameters made in float32 under any parameter dtype, set
# deterministically (as the reference's ``init_mamba`` makes them).
F32_PARAMS = ("A_log", "D", "dt_bias", "norm_w")


def dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    if n_heads * cfg.ssm_head_dim != d_inner:
        raise ValueError(f"{cfg.name}: d_inner {d_inner} is not a multiple "
                         f"of ssm_head_dim {cfg.ssm_head_dim}")
    return d_inner, n_heads, cfg.ssm_state


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                     Optional[float]]]:
    """Parameter name → (shape, init stddev); the ``F32_PARAMS`` have
    stddev None."""
    d = cfg.d_model
    d_inner, nh, n = dims(cfg)
    gbc = 2 * N_GROUPS * n
    std = d ** -0.5
    return {"wz": ((d, d_inner), std), "wx": ((d, d_inner), std),
            "wbc": ((d, gbc), std), "wdt": ((d, nh), std),
            "conv_x": ((cfg.ssm_conv, d_inner), 0.3),
            "conv_bc": ((cfg.ssm_conv, gbc), 0.3),
            "A_log": ((nh,), None), "D": ((nh,), None),
            "dt_bias": ((nh,), None), "norm_w": ((d_inner,), None),
            "wo": ((d_inner, d), d_inner ** -0.5)}


def mamba_specs(cfg: ArchConfig, ax: AxisSizes) -> Dict:
    """The reference's parameter specs of one Mamba2 layer."""
    d = cfg.d_model
    d_inner, nh, n = dims(cfg)
    gbc = 2 * N_GROUPS * n
    return {
        "wz": ax.spec(("data", "model"), (d, d_inner)),
        "wx": ax.spec(("data", "model"), (d, d_inner)),
        "wbc": ax.spec(("data", None), (d, gbc)),
        "wdt": ax.spec(("data", "model"), (d, nh)),
        "conv_x": ax.spec((None, "model"), (cfg.ssm_conv, d_inner)),
        "conv_bc": ax.spec((None, None), (cfg.ssm_conv, gbc)),
        "A_log": ax.spec(("model",), (nh,)),
        "D": ax.spec(("model",), (nh,)),
        "dt_bias": ax.spec(("model",), (nh,)),
        "norm_w": ax.spec(("model",), (d_inner,)),
        "wo": ax.spec(("model", "data"), (d_inner, d)),
    }


def init_mamba(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """Random matrices from ``kg`` in ``dtype``; ``A_log = log(linspace(1,
    16, heads))``, ``D = 1``, ``dt_bias = 0`` and ``norm_w = 0`` in
    float32."""
    out = {name: normal_init(kg(), shape, std, dtype, device)
           for name, (shape, std) in mamba_shapes(cfg).items()
           if std is not None}
    d_inner, nh, _ = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    out["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    out["D"] = torch.ones(nh, **f32)
    out["dt_bias"] = torch.zeros(nh, **f32)
    out["norm_w"] = torch.zeros(d_inner, **f32)
    return out


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(*promote(x, w))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (b, l, c); w: (k, c)."""
    k, l = w.shape[0], x.shape[1]
    x, w = promote(x, w)
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + l, :] * w[i] for i in range(k))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) → (..., q, q) with out[i,j] = sum_{j<m<=i} a_m (i>=j),
    -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), float("-inf"),
                                              dtype=diff.dtype,
                                              device=a.device))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                chunk: int = CHUNK, impl: str = "torch"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (b, l, h, p); a: (b, l, h) log-decay (≤ 0);
    B, C: (b, l, g, n). Returns (y: (b, l, h, p), final state (b, h, p,
    n) in float32). ``chunk = min(chunk, l)`` must divide l."""
    if impl == "cuda":
        return ops.ssd(x, a, B, C, init_state=init_state, chunk=chunk)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    chunk = min(chunk, l)
    nc = l // chunk
    if nc * chunk != l:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)      # (b,h,nc,q)
    a_cum = torch.cumsum(ac, dim=-1)
    L = torch.exp(_segsum(ac))                               # (b,h,nc,q,q)
    # The reference's einsums promote bfloat16 x / B / C to L's float32.
    xc, Bh, Ch, L = promote(
        x.reshape(b, nc, chunk, h, p),
        torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3),
        torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3),
        L)
    # 1. Intra-chunk (quadratic, attention-like).
    cb = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb * L, xc)
    # 2. Chunk states, float32.
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (b,h,nc,q)
    states = torch.einsum(
        "bcshn,bcshp->bchpn", Bh,
        xc * decay_states.permute(0, 2, 3, 1)[..., None]).float()
    # 3. Inter-chunk recurrence.
    chunk_decay = torch.exp(a_cum[..., -1]).float()          # (b,h,nc)
    carry = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)
    # 4. Off-diagonal (state → output).
    state_decay_out = torch.exp(a_cum).permute(0, 2, 3, 1)   # (b,nc,q,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) \
        * state_decay_out[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y, carry


def _split_bc(bc: torch.Tensor, n: int):
    Bp, Cp = bc[..., :N_GROUPS * n], bc[..., N_GROUPS * n:]
    return (Bp.reshape(*bc.shape[:-1], N_GROUPS, n),
            Cp.reshape(*bc.shape[:-1], N_GROUPS, n))


def _local_dims(p: Dict, cfg: ArchConfig) -> Tuple[int, int, int]:
    """``dims`` of the weights at hand: on a rank of a mesh, its share of
    ``d_inner`` and of the heads."""
    return p["wx"].shape[-1], p["wdt"].shape[-1], cfg.ssm_state


def _mamba_forward(p: Dict, u: torch.Tensor, cfg: ArchConfig, impl: str,
                   group=None):
    """``group``: the heads are split over that group's ranks (per-rank
    code), and the gated norm's mean runs over all of them."""
    b, l, d = u.shape
    d_inner, nh, n = _local_dims(p, cfg)
    z = _mm(u, p["wz"])
    x = F.silu(_causal_conv(_mm(u, p["wx"]), p["conv_x"]))
    bc = F.silu(_causal_conv(_mm(u, p["wbc"]), p["conv_bc"]))
    dt = F.softplus(_mm(u, p["wdt"]).float() + p["dt_bias"])   # (b,l,nh)
    A = -torch.exp(p["A_log"])                                  # (nh,) < 0
    B_, C_ = _split_bc(bc, n)
    xh = x.reshape(b, l, nh, cfg.ssm_head_dim)
    a = (dt * A).float()
    y, state = ssd_chunked(xh * dt[..., None].to(xh.dtype), a, B_, C_,
                           impl=impl)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = rms_norm_gated(y.reshape(b, l, d_inner), z, p["norm_w"],
                       group=group).to(u.dtype)
    return _mm(y, p["wo"]), state


# On a mesh (DTensor inputs) a Mamba2 layer runs per rank: the rows over
# the batch axes, the heads (and their d_inner channels) over "model"
# where they divide it; B / C, shared by every head, are whole on each
# rank. The output projection's result is each rank's partial sum.

_MAMBA_SPLIT = {"wz": 1, "wx": 1, "wdt": 1, "conv_x": 1, "A_log": 0,
                "D": 0, "dt_bias": 0, "norm_w": 0, "wo": 0}


def _mamba_split(p: Dict, u, cfg: ArchConfig):
    ax = axes_of(u)
    bt = batch_split(ax, u.shape[0])
    hx = split_axis(ax, dims(cfg)[1])
    names = sorted(p)
    wdims = [tuple(hx if i == _MAMBA_SPLIT.get(k) else None
                   for i in range(p[k].dim())) for k in names]
    group = ax.mesh.get_group("model") if hx is not None else None
    return ax, bt, hx, names, wdims, group


def _mamba_per_rank(body, p: Dict, u, cfg: ArchConfig, cache_args=(),
                    cache_dims=(), out_dims=()):
    """``body(u_local, *cache_local, p_local, group)`` per rank; its
    first output is the layer's (partial over "model"), the others are
    ``out_dims``."""
    ax, bt, hx, names, wdims, group = _mamba_split(p, u, cfg)
    k = len(names)

    def local(*a):
        return body(a[0], *a[1:-k], dict(zip(names, a[-k:])), group)

    dims_of = {"state": (bt, hx, None, None), "conv_x": (bt, None, hx),
               "conv_bc": (bt, None, None)}
    return per_rank(local, ax, (u, *cache_args, *[p[n] for n in names]),
                    [(bt, None, None)] + [dims_of[c] for c in cache_dims]
                    + wdims,
                    [(bt, None, None)] + [dims_of[c] for c in out_dims],
                    partial=[hx])


def mamba_full(p: Dict, u: torch.Tensor, cfg: ArchConfig,
               impl: str = "torch") -> torch.Tensor:
    """Full-sequence pass (no state emitted). u: (b, l, d)."""
    if is_dtensor(u):
        return _mamba_per_rank(
            lambda u_, w, g: _mamba_forward(w, u_, cfg, impl, g)[0], p, u,
            cfg)
    return _mamba_forward(p, u, cfg, impl)[0]


def mamba_cache_shapes(cfg: ArchConfig,
                       batch: int) -> Dict[str, Tuple[int, ...]]:
    """The shapes of ``init_mamba_cache``'s tensors."""
    d_inner, nh, n = dims(cfg)
    gbc = 2 * N_GROUPS * n
    return {"state": (batch, nh, cfg.ssm_head_dim, n),
            "conv_x": (batch, cfg.ssm_conv - 1, d_inner),
            "conv_bc": (batch, cfg.ssm_conv - 1, gbc)}


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in mamba_cache_shapes(cfg, batch).items()}


def mamba_prefill(p: Dict, u: torch.Tensor, cfg: ArchConfig, cache: Dict,
                  impl: str = "torch") -> Tuple[torch.Tensor, Dict]:
    """Prefill u: (b, l, d); writes the final state and the last
    ``ssm_conv - 1`` pre-conv projections into ``cache`` in place."""
    tail = cfg.ssm_conv - 1
    if u.shape[1] < tail:
        raise ValueError(f"a prompt of {u.shape[1]} tokens is shorter than "
                         f"the conv window's {tail}")
    if is_dtensor(u):
        def body(u_, w, g):
            out_, state_ = _mamba_forward(w, u_, cfg, impl, g)
            t = u_[:, -tail:, :]
            return out_, state_, _mm(t, w["wx"]), _mm(t, w["wbc"])

        out, state, cx, cbc = _mamba_per_rank(
            body, p, u, cfg, out_dims=("state", "conv_x", "conv_bc"))
        assign_(cache["state"], state)
        assign_(cache["conv_x"], cx)
        assign_(cache["conv_bc"], cbc)
        return out, cache
    out, state = _mamba_forward(p, u, cfg, impl)
    tail_u = u[:, -tail:, :]
    assign_(cache["state"], state)
    assign_(cache["conv_x"], _mm(tail_u, p["wx"]))
    assign_(cache["conv_bc"], _mm(tail_u, p["wbc"]))
    return out, cache


def mamba_decode(p: Dict, u: torch.Tensor, cfg: ArchConfig,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. u: (b, 1, d); ``cache`` updated in
    place."""
    if is_dtensor(u):
        def body(u_, st, cx, cbc, w, g):
            c = {"state": st.clone(), "conv_x": cx.clone(),
                 "conv_bc": cbc.clone()}
            out_, c = _mamba_step(w, u_, cfg, c, g)
            return out_, c["state"], c["conv_x"], c["conv_bc"]

        names = ("state", "conv_x", "conv_bc")
        out, *new = _mamba_per_rank(body, p, u, cfg,
                                    [cache[k] for k in names], names,
                                    names)
        for k, v in zip(names, new):
            assign_(cache[k], v)
        return out, cache
    return _mamba_step(p, u, cfg, cache)


def _mamba_step(p: Dict, u: torch.Tensor, cfg: ArchConfig, cache: Dict,
                group=None) -> Tuple[torch.Tensor, Dict]:
    b = u.shape[0]
    d_inner, nh, n = _local_dims(p, cfg)
    ut = u[:, 0, :]
    z = _mm(ut, p["wz"])
    # Depthwise conv over the cached window (float32 caches promote).
    cx = torch.cat(promote(cache["conv_x"], _mm(ut, p["wx"])[:, None, :]),
                   dim=1)
    cbc = torch.cat(promote(cache["conv_bc"],
                            _mm(ut, p["wbc"])[:, None, :]), dim=1)
    x = F.silu(torch.einsum("bkc,kc->bc", *promote(cx, p["conv_x"])))
    bc = F.silu(torch.einsum("bkc,kc->bc", *promote(cbc, p["conv_bc"])))
    dt = F.softplus(_mm(ut, p["wdt"]).float() + p["dt_bias"])   # (b,nh)
    A = -torch.exp(p["A_log"])
    B_, C_ = _split_bc(bc, n)                                   # (b,g,n)
    rep = nh // N_GROUPS
    Bh = torch.repeat_interleave(B_, rep, dim=1).float()        # (b,nh,n)
    Ch = torch.repeat_interleave(C_, rep, dim=1).float()
    xh = x.reshape(b, nh, cfg.ssm_head_dim).float()
    dA = torch.exp(dt * A)                                      # (b,nh)
    state = cache["state"].float() * dA[..., None, None] \
        + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = (y + p["D"][:, None] * xh).reshape(b, d_inner).to(u.dtype)
    y = rms_norm_gated(y, z, p["norm_w"], group=group)
    out = _mm(y, p["wo"])[:, None, :]
    assign_(cache["state"], state)
    assign_(cache["conv_x"], cx[:, 1:, :])
    assign_(cache["conv_bc"], cbc[:, 1:, :])
    return out, cache
