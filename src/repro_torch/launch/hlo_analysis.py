"""Roofline terms of a counted cell: the counterpart of
``repro.launch.hlo_analysis``.

The reference reads a compiled XLA executable: ``cost_analysis()`` for
FLOPs and bytes, the HLO text for collective bytes and
``memory_analysis()`` for the footprint per device. The port has no
compiled artifact; ``analyze`` takes the cell that ``launch.cells``
counted on the meta device (its FLOPs, bytes and forecast peak memory)
and keeps the module's name so that a reader finds the counterpart.

There is no HLO to parse: the reference's collective parser
(``collective_bytes``) becomes a ``TorchDispatchMode`` over the
collectives a program issues — the ``_c10d_functional`` ops DTensor
and ``local_map`` bodies issue, and the ``c10d`` ops of explicit
collectives. Like the reference it sums each collective's result bytes
(an all-gather's gathered tensor, an all-reduce's input, a
reduce-scatter's shard) by kind, with the counts, and it sees each
rank's own op: a DTensor op is let through (``NotImplemented``) so that
the mode sees the local ops and collectives it becomes. On one card the
collective term is 0.

Hardware model: H100 SXM cards, the constants below with their sources.
The collective term of a layout of several cards is each card's own
collective bytes over its link: NVLink 4 for a group within one
8-card node, the node's network for a group that spans nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NETWORK_BW",
           "NODE_CARDS", "CARD_MEMORY_BYTES", "COLLECTIVES", "Collectives",
           "LocalOnly",
           "CollectiveCounter", "collective_bytes", "Roofline", "analyze",
           "model_flops_estimate"]

# Dense bfloat16 tensor-core peak (NVIDIA H100 datasheet, SXM5: 989.4
# TFLOPS without sparsity).
PEAK_FLOPS = 989e12
# HBM3 bandwidth (H100 SXM5 datasheet: 3.35 TB/s).
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a GPU in both directions, 450 GB/s each way.
NVLINK_BW = 450e9
# Cards an NVLink domain joins: one HGX H100 node.
NODE_CARDS = 8
# Between nodes: one 400 Gb/s InfiniBand NDR port a GPU (DGX H100),
# 50 GB/s each way.
NETWORK_BW = 50e9
# The H100 SXM's 80 GB of HBM3 (80 GiB of device memory).
CARD_MEMORY_BYTES = 80 * 2 ** 30


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# aten-level collective ops → the reference's HLO kinds.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _group_spans_nodes(args) -> bool:
    """Whether a functional collective's group (its name, the last
    string argument) holds ranks of more than one node."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return False
    ranks = dist.get_process_group_ranks(_resolve_process_group(names[-1]))
    return len({r // NODE_CARDS for r in ranks}) > 1


class Collectives:
    """Result bytes and counts of collectives by kind, and the bytes that
    cross nodes (``inter``) or stay within one (``intra``)."""

    def __init__(self):
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.elements = {k: 0 for k in COLLECTIVES}
        self.link = {"intra": 0, "inter": 0}

    def record(self, func, args, out) -> None:
        if func.namespace not in _NAMESPACES:
            return
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is None:
            return
        outs = _tensors(out)
        if func.namespace == "c10d":     # in place: the tensors it fills
            outs = _tensors(args[0])
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        self.bytes[kind] += nbytes
        self.counts[kind] += 1
        self.elements[kind] += sum(t.numel() for t in outs)
        inter = func.namespace != "c10d" and _group_spans_nodes(args)
        self.link["inter" if inter else "intra"] += nbytes

    def result(self) -> Dict:
        """The reference's dict: bytes by kind and ``_counts``; here
        also ``_elements`` by kind (the comparison with XLA's CPU
        backend, which widens bfloat16 collectives to float32) and
        ``_link``, the bytes within and across nodes."""
        return {**self.bytes, "_counts": dict(self.counts),
                "_elements": dict(self.elements),
                "_link": dict(self.link)}


def _has_dtensor(types) -> bool:
    return any(t.__name__ == "DTensor" for t in types)


class LocalOnly:
    """Hides DTensor's sharding propagation from the dispatch modes that
    are active: to find an op's output shape it runs the op on meta
    tensors of the *global* shapes, which a mode that counts each rank's
    own ops would otherwise count and keep alive. Entered by the
    counters (``CollectiveCounter``, ``cells.CostCounter``)."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import _disable_current_modes
        prop = DTensor._op_dispatcher.sharding_propagator
        self._prop = prop
        self._orig = prop._propagate_tensor_meta_non_cached

        def quiet(*args, **kwargs):
            with _disable_current_modes():
                return self._orig(*args, **kwargs)

        prop._propagate_tensor_meta_non_cached = quiet
        return self

    def __exit__(self, *exc):
        self._prop._propagate_tensor_meta_non_cached = self._orig
        return False


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives of each rank's local program: DTensor ops
    are let through (``NotImplemented``), so the mode sees the local ops
    and the collectives DTensor issues, with local shapes."""

    def __init__(self):
        super().__init__()
        self.collectives = Collectives()
        self._local = LocalOnly()

    def __enter__(self):
        self._local.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self._local.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.collectives.record(func, args, out)
        return out


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict:
    """The counterpart of the reference's ``collective_bytes(hlo_text)``:
    runs ``fn(*args, **kwargs)`` and returns the result bytes of its
    collectives by kind (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``), with
    ``_counts`` and ``_link`` (bytes within and across nodes). A loop
    is counted as it runs, every trip."""
    with CollectiveCounter() as c:
        fn(*args, **kwargs)
    return c.collectives.result()


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: Dict[str, int]
    model_flops: Optional[float] = None
    memory_per_device: Optional[float] = None
    coll_seconds: float = 0.0     # each card's time on its links

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_seconds

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time (how close to roofline)."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        if bound <= 0:
            return 0.0
        useful = (self.model_flops or self.hlo_flops) / \
            (self.chips * PEAK_FLOPS)
        return useful / bound

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": (self.model_flops / self.hlo_flops
                             if self.model_flops and self.hlo_flops else None),
            "roofline_fraction": self.roofline_fraction,
            "mem_per_device_gb": (self.memory_per_device / 2**30
                                  if self.memory_per_device else None),
        }


def analyze(arch: str, shape: str, counted: Dict, chips: int = 1,
            model_flops: Optional[float] = None,
            flops_override: Optional[float] = None,
            bytes_override: Optional[float] = None) -> Roofline:
    """The roofline of a cell counted by ``launch.cells.count_cell``
    (``counted``: its ``flops``, ``bytes``, ``peak_bytes`` and
    ``collectives``), on ``chips`` cards. ``counted`` holds one card's
    counts (on a layout of several cards, each rank's local program):
    the global FLOPs and bytes are ``chips`` times those, unless
    ``flops_override`` / ``bytes_override`` carry the counts of
    ``launch.cells.analytic_cost``, as in the reference. The collective
    term is the card's own collective bytes over its links (0 on one
    card)."""
    flops = counted["flops"] * chips if flops_override is None \
        else flops_override
    byts = counted["bytes"] * chips if bytes_override is None \
        else bytes_override
    coll = counted.get("collectives") or Collectives().result()
    total = sum(v for k, v in coll.items() if not k.startswith("_"))
    link = coll.get("_link", {})
    seconds = link.get("intra", 0) / NVLINK_BW + \
        link.get("inter", 0) / NETWORK_BW
    return Roofline(arch, shape, chips, float(flops), float(byts),
                    float(total), coll, model_flops=model_flops,
                    memory_per_device=counted.get("peak_bytes"),
                    coll_seconds=seconds)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training; 2·N_active·D for a
    forward-only cell (prefill) and 2·N_active·B for one decode token."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch       # decode: one token / row
