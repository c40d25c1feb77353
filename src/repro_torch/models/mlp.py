"""Gated MLP and Mixture-of-Experts layers: the counterpart of
``repro.models.mlp``.

The products are plain ``torch.matmul`` / ``bmm`` calls, as the JAX
package left them to XLA outside any Pallas kernel. The MoE layer is the
reference's capacity-based top-k routing on one device: its
``shard_map`` over a one-device mesh runs ``_moe_local`` once over all
tokens of the call, with the expert FFN unsharded, and so does
``moe_mlp`` here. Tokens are dispatched into an (experts, capacity, d)
buffer, the experts run as one batched product, and the outputs are
gathered back and weighted by the renormalised router probabilities.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import KeyGen, normal_init, promote

__all__ = ["dense_mlp_shapes", "init_dense_mlp", "dense_mlp",
           "moe_mlp_shapes", "init_moe", "moe_mlp", "CAPACITY_FACTOR",
           "ROUTER_DTYPE"]

CAPACITY_FACTOR = 1.25
# The router's weights are float32 whatever the parameter dtype.
ROUTER_DTYPE = torch.float32


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



# ----------------------------------------------------------------------- MoE

def moe_mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                       float]]:
    """Parameter name → (shape, init stddev); the router is float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ((d, e), d ** -0.5), "w1": ((e, d, f), d ** -0.5),
            "w3": ((e, d, f), d ** -0.5), "w2": ((e, f, d), f ** -0.5)}


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


def moe_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d): top-k routing over all B·S tokens with a
    per-expert capacity; (token, choice) pairs past it are dropped."""
    b, s, d = x.shape
    xl = x.reshape(b * s, d)
    nl, e, k = b * s, cfg.n_experts, cfg.experts_per_token
    cap = _capacity(nl, cfg)
    pk, ik, slot, keep = _route(xl, p["router"], cfg)
    # Dispatch: each kept pair owns its (expert, slot), so the reference's
    # scatter-add into zeros is a plain write. Every pair is written, with
    # static shapes (no boolean indexing, so no host sync and a meta
    # route): a kept pair to row expert · cap + slot of a flat buffer, a
    # dropped one to the spare last row, which the (e, cap, d) view
    # leaves out.
    dest = torch.where(keep, ik * cap + slot, e * cap).reshape(-1)
    buf = xl.new_zeros(e * cap + 1, d)
    buf.index_copy_(0, dest, xl.repeat_interleave(k, dim=0))
    buf = buf[:e * cap].view(e, cap, d)
    a, w1 = promote(buf, p["w1"])
    h = torch.nn.functional.silu(torch.bmm(a, w1)) \
        * torch.bmm(a, p["w3"].to(a.dtype))
    out_e = torch.bmm(*promote(h, p["w2"]))                   # (e, cap, d)
    # Combine: gather back (0 where dropped) and weight by the router.
    gathered = out_e[ik, slot.clamp_max(cap - 1)].masked_fill(
        ~keep[..., None], 0)                                  # (nl, k, d)
    out = (gathered * pk[..., None]).sum(1)
    return out.reshape(b, s, -1)
