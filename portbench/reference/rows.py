"""The reference rows: each sweep point run through the frozen event
engine on the lane's own trace, the semantics the program's fast paths
are held to. A point is the dict the cell's traffic file lists (the
fields of the program's ``SweepPoint``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from portbench.reference.engine import (build_dcs, build_ec2_rightscale,
                                        build_fb, build_flb_nub, clone_jobs,
                                        run_sim)
from portbench.reference.jobs import Job


def build(point: Dict):
    kind = point["system"]
    lease = float(point.get("lease_seconds", 3600.0))
    if kind == "dcs":
        return build_dcs(point["prc_pbj"], point["prc_ws"], lease)
    if kind == "fb":
        return build_fb(point["capacity"], lease)
    if kind == "flb_nub":
        return build_flb_nub(point["lb_pbj"], point["lb_ws"], lease)
    if kind == "ec2":
        return build_ec2_rightscale(lease)
    raise ValueError(f"unknown system {kind!r}")


def reference_row(point: Dict, jobs: Sequence[Job],
                  ws_trace: Sequence[Tuple[float, int]],
                  duration: float) -> Dict:
    return run_sim(build(point), clone_jobs(jobs), ws_trace, duration).row()
