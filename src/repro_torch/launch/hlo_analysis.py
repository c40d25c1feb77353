"""Roofline terms of a counted cell: the counterpart of
``repro.launch.hlo_analysis``.

The reference reads a compiled XLA executable: ``cost_analysis()`` for
FLOPs and bytes, the HLO text for collective bytes and
``memory_analysis()`` for the footprint per device. The port has no
compiled artifact; ``analyze`` takes the cell that ``launch.cells``
counted on the meta device (its FLOPs, bytes and forecast peak memory)
and keeps the module's name so that a reader finds the counterpart.

There is no HLO to parse, so the reference's collective parser
(``collective_bytes``) has no counterpart: on one card the collective
term is 0. Collective bytes under a pod layout come from the sharding
specs (ROADMAP A3).

Hardware model: one H100 SXM, the constants below with their sources.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "CARD_MEMORY_BYTES",
           "Roofline", "analyze", "model_flops_estimate"]

# Dense bfloat16 tensor-core peak (NVIDIA H100 datasheet, SXM5: 989.4
# TFLOPS without sparsity).
PEAK_FLOPS = 989e12
# HBM3 bandwidth (H100 SXM5 datasheet: 3.35 TB/s).
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a GPU in both directions, 450 GB/s each way.
NVLINK_BW = 450e9
# The H100 SXM's 80 GB of HBM3 (80 GiB of device memory).
CARD_MEMORY_BYTES = 80 * 2 ** 30


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

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

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
    (``counted``: its ``flops``, ``bytes`` and ``peak_bytes``).
    ``flops_override`` / ``bytes_override`` carry the counts of
    ``launch.cells.analytic_cost``, as in the reference; the collective
    term is 0 on one card."""
    if chips != 1:
        raise NotImplementedError(
            f"chips={chips}: collective bytes under a layout of more than "
            f"one card need the sharding specs (ROADMAP A3)")
    flops = counted["flops"] if flops_override is None else flops_override
    byts = counted["bytes"] if bytes_override is None else bytes_override
    return Roofline(arch, shape, chips, float(flops), float(byts), 0.0, {},
                    model_flops=model_flops,
                    memory_per_device=counted.get("peak_bytes"))


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training; 2·N_active·D for a
    forward-only cell (prefill) and 2·N_active·B for one decode token."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch       # decode: one token / row
