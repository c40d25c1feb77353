"""Gated MLP and Mixture-of-Experts layers: the counterpart of
``repro.models.mlp``.

The products are plain ``torch.matmul`` / ``bmm`` calls, as the JAX
package left them to XLA outside any Pallas kernel. The MoE layer is the
reference's capacity-based top-k routing: tokens are dispatched into an
(experts, capacity, d) buffer, the experts run as one batched product,
and the outputs are gathered back and weighted by the renormalised
router probabilities.

Off a mesh ``moe_mlp`` runs that body once over all tokens of the call,
as the reference's ``shard_map`` over a one-device mesh does. Under a
mesh (DTensor inputs) the reference's ``shard_map`` becomes
``sharding.per_rank``: tokens are sharded over the batch axes when they
divide, ``w1`` / ``w3`` / ``w2`` over ``"model"`` along ``d_ff`` when it
divides, each rank routes and dispatches its own tokens, and the expert
outputs are summed over the ``"model"`` group in the compute
dtype (the reference's ``psum``) before the router weights are applied.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (AxisSizes, KeyGen, all_reduce_bwd,
                                       all_reduce_fwd, axes_of,
                                       batch_split, is_dtensor,
                                       normal_init, per_rank, promote,
                                       split_axis)

__all__ = ["dense_mlp_shapes", "dense_mlp_specs", "init_dense_mlp",
           "dense_mlp", "moe_mlp_shapes", "moe_specs", "init_moe",
           "moe_mlp", "CAPACITY_FACTOR", "ROUTER_DTYPE"]

CAPACITY_FACTOR = 1.25
# The router's weights are float32 whatever the parameter dtype.
ROUTER_DTYPE = torch.float32


def dense_mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                         float]]:
    """Parameter name → (shape, init stddev)."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": ((d, f), d ** -0.5), "w3": ((d, f), d ** -0.5),
            "w2": ((f, d), f ** -0.5)}


def dense_mlp_specs(cfg: ArchConfig, ax: AxisSizes) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ax.spec(("data", "model"), (d, f)),
        "w3": ax.spec(("data", "model"), (d, f)),
        "w2": ax.spec(("model", "data"), (f, d)),
    }


def init_dense_mlp(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    return {name: normal_init(kg(), shape, std, dtype, device)
            for name, (shape, std) in dense_mlp_shapes(cfg).items()}


def dense_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w1 and x @ w3, gated, @ w2. On a mesh each rank takes its
    tokens and its slice of ``d_ff`` (over "model" where it divides),
    and the result is its partial sum over "model"."""
    if is_dtensor(x):
        ax = axes_of(x)
        bt = batch_split(ax, x.shape[0])
        f = split_axis(ax, p["w1"].shape[-1])
        return per_rank(
            lambda x_, w1, w3, w2: dense_mlp({"w1": w1, "w3": w3,
                                              "w2": w2}, x_),
            ax, (x, p["w1"], p["w3"], p["w2"]),
            [(bt, None, None), (None, f), (None, f), (f, None)],
            [(bt, None, None)], partial=[f])
    a, w1 = promote(x, p["w1"])
    h = torch.nn.functional.silu(a @ w1) * (a @ p["w3"].to(a.dtype))
    return torch.matmul(*promote(h, p["w2"]))



# ----------------------------------------------------------------------- MoE

def moe_mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                       float]]:
    """Parameter name → (shape, init stddev); the router is float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ((d, e), d ** -0.5), "w1": ((e, d, f), d ** -0.5),
            "w3": ((e, d, f), d ** -0.5), "w2": ((e, f, d), f ** -0.5)}


def moe_specs(cfg: ArchConfig, ax: AxisSizes) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (None, None),
        "w1": ax.spec((None, "data", "model"), (e, d, f)),
        "w3": ax.spec((None, "data", "model"), (e, d, f)),
        "w2": ax.spec((None, "model", "data"), (e, f, d)),
    }


def init_moe(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
    return {name: normal_init(kg(), shape, std,
                              ROUTER_DTYPE if name == "router" else dtype,
                              device)
            for name, (shape, std) in moe_mlp_shapes(cfg).items()}


def _capacity(n_local: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``n_local`` tokens, a multiple of 8."""
    c = int(cfg.experts_per_token * n_local * CAPACITY_FACTOR
            / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _route(xl: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of the tokens ``xl`` (n, d): the renormalised
    probabilities ``pk`` (compute dtype) and experts ``ik`` of each
    token's k choices, each pair's ``slot`` within its expert (its
    position among the flattened (token, choice) pairs, row-major) and
    ``keep``, the pairs within the expert's capacity."""
    nl, e, k = xl.shape[0], cfg.n_experts, cfg.experts_per_token
    logits = xl.float() @ router.float()                      # (nl, e)
    pk, ik = torch.topk(torch.softmax(logits, -1), k)        # (nl, k)
    pk = (pk / pk.sum(-1, keepdim=True)).to(xl.dtype)
    # The reference's (cumsum(onehot, 0) * onehot).sum(-1) - 1: the count
    # of earlier-or-equal pairs on the pair's own expert, less one. The
    # running counts run along the pairs as each expert's row of the
    # transposed one-hot (an inner-dimension scan: a scan down the
    # (pairs, experts) columns took 113 ms a layer at 294 k pairs on an
    # H100), and each pair reads its own expert's count.
    flat = ik.reshape(1, -1)                                  # (1, nl*k)
    counts = torch.zeros(e, flat.shape[1], dtype=torch.int32,
                         device=ik.device).scatter_(0, flat, 1).cumsum(1)
    slot = (counts.gather(0, flat) - 1).reshape(nl, k)
    return pk, ik, slot, slot < _capacity(nl, cfg)


def _moe_local(xl: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, cfg: ArchConfig,
               model_group=None) -> torch.Tensor:
    """The MoE over one rank's tokens ``xl`` (n, d): routing, dispatch,
    the expert FFN over this rank's ``d_ff`` slice and, with
    ``model_group``, the sum of the expert outputs over that group."""
    nl, d = xl.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(nl, cfg)
    pk, ik, slot, keep = _route(xl, router, cfg)
    xe = xl if model_group is None else all_reduce_bwd(xl, model_group)
    # Dispatch: each kept pair owns its (expert, slot), so the reference's
    # scatter-add into zeros is a plain write. Every pair is written, with
    # static shapes (no boolean indexing, so no host sync and a meta
    # route): a kept pair to row expert · cap + slot of a flat buffer, a
    # dropped one to the spare last row, which the (e, cap, d) view
    # leaves out.
    dest = torch.where(keep, ik * cap + slot, e * cap).reshape(-1)
    buf = xe.new_zeros(e * cap + 1, d)
    buf.index_copy_(0, dest, xe.repeat_interleave(k, dim=0))
    buf = buf[:e * cap].view(e, cap, d)
    a, w1 = promote(buf, w1)
    h = torch.nn.functional.silu(torch.bmm(a, w1)) \
        * torch.bmm(a, w3.to(a.dtype))
    out_e = torch.bmm(*promote(h, w2))                        # (e, cap, d)
    if model_group is not None:
        # Combine in the compute dtype, as the reference's psum does; the
        # router weights are applied after the sum.
        out_e = all_reduce_fwd(out_e.to(xl.dtype), model_group)
    # Combine: gather back (0 where dropped) and weight by the router.
    gathered = out_e[ik, slot.clamp_max(cap - 1)].masked_fill(
        ~keep[..., None], 0)                                  # (nl, k, d)
    return (gathered * pk[..., None]).sum(1)


def moe_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig,
            ax: Optional[AxisSizes] = None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d): top-k routing over the tokens with a
    per-expert capacity; (token, choice) pairs past it are dropped. Off
    a mesh (``ax`` None or without one) every token is routed at once;
    on one the tokens and the expert weights are sharded as the module
    docstring says, and each rank routes its own tokens."""
    b, s, d = x.shape
    if ax is None or ax.mesh is None or not is_dtensor(x):
        return _moe_local(x.reshape(b * s, d), p["router"], p["w1"],
                          p["w3"], p["w2"], cfg).reshape(b, s, -1)
    # The rows over the batch axes where they divide them (the reference
    # shards the flattened tokens; a rank's tokens are its rows here), the
    # expert weights over "model" along d_ff where it divides.
    bt = batch_split(ax, b)
    f = split_axis(ax, cfg.d_ff)
    group = ax.mesh.get_group("model") if f else None

    def body(xl, router, w1_, w3_, w2_):
        bl = xl.shape[0]
        return _moe_local(xl.reshape(bl * s, d), router, w1_, w3_, w2_, cfg,
                          group).reshape(bl, s, d)

    # Gradients: the tokens' is whole on every "model" rank (the dispatch
    # path's is summed over "model" by ``all_reduce_bwd``, the router
    # path's is the same on each); the router's is partial on the batch
    # ranks only (every "model" rank routes the same tokens); the expert
    # weights' partial on the batch ranks, and sharded or whole on
    # "model" (the default).
    return per_rank(body, ax, (x, p["router"], p["w1"], p["w3"], p["w2"]),
                    [(bt, None, None), (None, None), (None, None, f),
                     (None, None, f), (None, f, None)],
                    [(bt, None, None)],
                    grad_partial=[(), bt, None, None, None])
