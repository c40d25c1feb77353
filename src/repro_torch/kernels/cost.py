"""The work of the model kernels, and the hook that counts it.

One copy of the formulas that ``chip_smoke.py`` uses for each kernel's
bound and that the dry run (``launch/cells.py``) counts for a kernel
route on the meta device: the products each kernel computes (2 FLOPs a
multiply-add, the softmax's and the decay's elementwise work left out)
and the bytes it must move (each input read once, each output written
once).

``report`` hands a kernel route's cost to every active counter
(``sinks``; a counter adds itself while it counts). Nothing listens
outside a dry run, and the CUDA wrappers do not report: only the meta
routes of ``kernels/ops.py`` do, in place of a launch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

__all__ = ["H100_SMS", "visible_pairs", "attention_cost", "decode_cost",
           "ssd_cost", "report", "sinks"]

# Streaming multiprocessors of an H100 SXM: the flash-decode wrapper's
# split (one block per SM) on a device it cannot ask.
H100_SMS = 132

# Active counters: each is called with (kernel name, flops, bytes).
sinks: List[Callable[[str, float, float], None]] = []


def report(name: str, flops: float, nbytes: float) -> None:
    for sink in sinks:
        sink(name, flops, nbytes)


def visible_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs causal attention with ``window`` evaluates."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_cost(q: torch.Tensor, k: torch.Tensor,
                   window: Optional[int],
                   causal: bool = True) -> Tuple[int, int]:
    """Flash attention in the kernel's layout, q (BH, S, hd) and k / v
    (BKV, S, hd): Q·Kᵀ and P·V over the visible pairs (all S² without
    ``causal``); q, k and v read, the output written."""
    bh, s, hd = q.shape
    pairs = visible_pairs(s, window) if causal else s * k.shape[1]
    flops = 4 * hd * pairs * bh
    return flops, q.element_size() * 2 * (q.numel() + k.numel())


def decode_cost(q: torch.Tensor, k: torch.Tensor,
                n_visible: int) -> Tuple[int, int]:
    """Flash decode in the kernel's layout, q (BKV, G, hd) and k / v
    (BKV, S, hd), over ``n_visible`` keys of each row: the visible K and V
    rows read, q read and the output written."""
    bkv, g, hd = q.shape
    flops = 4 * hd * n_visible * bkv * g
    nbytes = k.element_size() * 2 * bkv * n_visible * hd \
        + 2 * q.element_size() * q.numel()
    return flops, nbytes


def ssd_cost(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int,
             with_s0: bool) -> Tuple[int, int]:
    """The SSD scan in the kernel's layout, x (BH, L, P), a (BH, L), B /
    C (BH, L, N), ``chunk`` dividing L: per chunk C·Bᵀ and (C·Bᵀ∘L)·x
    over the Q(Q+1)/2 pairs the mask keeps, C·Sᵀ and (x∘w)ᵀ·B in full;
    x, a, B, C (and s0) read, y and the final state written."""
    bh, l, p = x.shape
    n = B.shape[-1]
    pairs = chunk * (chunk + 1) // 2
    flops = bh * (l // chunk) * (2 * pairs * (n + p) + 4 * chunk * n * p)
    nbytes = (x.element_size() * (2 * x.numel() + B.numel() + C.numel())
              + 4 * a.numel() + 4 * bh * p * n * (2 if with_s0 else 1))
    return flops, nbytes
