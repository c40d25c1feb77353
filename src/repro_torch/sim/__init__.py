from repro_torch.sim.engine import (SimResult, build_dcs, build_ec2_rightscale,
                              build_fb, build_flb_nub, clone_jobs, run_sim)
from repro_torch.sim.traces import (TraceSpec, nasa_ipsc, scale_jobs, sdsc_blue,
                              worldcup98)

__all__ = [
    "SimResult", "run_sim", "clone_jobs", "build_dcs", "build_fb",
    "build_flb_nub", "build_ec2_rightscale", "SweepPoint", "ScanOptions",
    "run_sweep", "run_sweep_workloads", "paper_grid", "TraceSpec",
    "nasa_ipsc", "sdsc_blue", "worldcup98", "scale_jobs",
    "CapacitySLO", "CapacityReport", "min_capacity", "pareto_front",
    "ParetoFront", "CostModel", "CostEstimate", "ProviderRate",
    "headline_queries",
]

_SWEEP_NAMES = ("SweepPoint", "ScanOptions", "run_sweep",
                "run_sweep_workloads", "paper_grid")
_CAPACITY_NAMES = ("CapacitySLO", "CapacityResult", "CapacityReport",
                   "min_capacity", "ParetoPoint", "ParetoFront",
                   "pareto_front", "ProviderRate", "CostEstimate",
                   "CostModel", "DEFAULT_PROVIDERS", "headline_queries")


def __getattr__(name):
    # Lazy: the sweep engine (and the capacity query layer on top of
    # it) pulls in jax; the event engine and traces stay importable
    # with numpy alone.
    if name in _SWEEP_NAMES:
        from repro_torch.sim import sweep
        return getattr(sweep, name)
    if name in _CAPACITY_NAMES:
        from repro_torch.sim import capacity
        return getattr(capacity, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
