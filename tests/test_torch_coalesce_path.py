"""The coalesced path (``ScanOptions(coalesce=8)``) of the port on the CPU.

* ``headline_queries(tiny=True)`` with the coalescer on gives EXACTLY the
  JAX package's recorded tiny answers (``results/BENCH_capacity_tiny.json``),
  as the uncoalesced queries do (tests/test_torch_capacity.py).
* The crafted all-contended trace of the reference's coalescer regression
  (tests/test_engine_differential.py ``crafted_all_contended``): C unit
  jobs per generation, all submitted at 0, drained one generation at a
  time. The port's FB row equals the JAX package's ``fb_rounds_row`` with
  the same batch, rounds and coalesced counts included, and keeps the
  reference's exact turnaround.
* ``chain_barriers`` keeps its batch-1 counts and counts more barriers
  for a coalescing launch (an upper bound: every round with a queue).
* There is no CPU fallback for the kernel: ``kernel="cuda"`` on the CPU
  raises with the coalescer on as with it off, and ``chunk_step`` refuses
  CPU tensors at any batch without counting a launch.

The card-only comparisons of the coalescing kernel are in
tests/test_torch_cuda.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.core.jobs import Job as RefJob
from repro.sim import rounds as ref_rounds
from repro_torch.core.jobs import Job
from repro_torch.kernels import round_step as rsk
from repro_torch.sim import rounds
from repro_torch.sim.capacity import headline_queries
from repro_torch.sim.scan import FBGrid
from repro_torch.sim.sweep import ScanOptions, SweepPoint, run_sweep

RESULTS = Path(__file__).resolve().parents[1] / "results"
BATCH = rounds.COALESCE_BATCH
DAY = 24 * 3600.0


def crafted_all_contended():
    """The reference's crafted trace as numpy columns: C nodes, C * gens
    unit jobs of runtime rt all submitted at 0, flat zero WS demand, a
    lease longer than the horizon."""
    C, gens, rt = 16, 6, 1000.0
    n = C * gens
    submit, size, runtime = np.zeros(n), np.ones(n, int), np.full(n, rt)
    duration = gens * rt + 500.0
    return (submit, size, runtime), [(0.0, 0)], duration, 10 * duration, C


def test_tiny_coalesced_headline_equals_reference_record():
    want = json.loads((RESULTS / "BENCH_capacity_tiny.json").read_text()
                      )["headline"]
    got = headline_queries(tiny=True, device="cpu",
                           scan_options=ScanOptions(coalesce=BATCH))
    assert got["private"] == want["private"]
    assert got["public"] == want["public"]
    assert got["gate"]["ok"] and not got["gate"]["checked"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_crafted_all_contended_row_equals_reference(dtype):
    (submit, size, runtime), ws, duration, lease, C = crafted_all_contended()
    port_jobs = [Job(i, float(s), size=int(z), runtime=float(r))
                 for i, (s, z, r) in enumerate(zip(submit, size, runtime))]
    ref_jobs = [RefJob(i, float(s), size=int(z), runtime=float(r))
                for i, (s, z, r) in enumerate(zip(submit, size, runtime))]
    port = rounds.fb_rounds_row(port_jobs, ws, C, lease, duration,
                                batch=BATCH, dtype=dtype, device="cpu")
    with jax.enable_x64(dtype == np.float64):
        ref = ref_rounds.fb_rounds_row(ref_jobs, ws, C, lease, duration,
                                       batch=BATCH, dtype=dtype)
    gens = len(submit) // C
    assert port["completed_jobs"] == ref["completed_jobs"] == C * gens
    assert port["coalesced"] == ref["coalesced"] > 0
    assert port["rounds"] == ref["rounds"] <= np.ceil(C * gens / BATCH)
    # Generation k completes at exactly k * rt.
    assert port["avg_turnaround"] == ref["avg_turnaround"] \
        == runtime[0] * (gens + 1) / 2
    for k in ("peak_nodes", "kills", "window_overflow", "truncated",
              "avg_execution"):
        assert port[k] == ref[k], k
    assert port["node_hours"] == pytest.approx(ref["node_hours"], rel=1e-6)
    plain = rounds.fb_rounds_row(port_jobs, ws, C, lease, duration,
                                 dtype=dtype, device="cpu")
    assert port["rounds"] < plain["rounds"] and plain["coalesced"] == 0


def test_chain_barriers_batch_one_unchanged_and_coalescing_larger():
    spec = rounds.RoundsSpec(duration=DAY, max_rounds=64,
                             window=rounds.FB_ROUNDS_WINDOW)
    flb = rounds.RoundsSpec(duration=DAY, max_rounds=64,
                            window=rounds.FLB_ROUNDS_WINDOW)
    assert rsk.chain_barriers("fb", spec) == 203
    assert rsk.chain_barriers("flb_nub", flb) == 243
    coal = {p: rsk.chain_barriers(p, rounds.RoundsSpec(
        duration=DAY, max_rounds=64, window=s.window, batch=BATCH))
        for p, s in (("fb", spec), ("flb_nub", flb))}
    # Per engaged round: + 2 * batch + 7 for the coalescer, - 6 for the
    # horizon reductions it makes unneeded.
    assert coal == {"fb": 203 + 8 * (2 * BATCH + 1),
                    "flb_nub": 243 + 8 * (2 * BATCH + 1)}
    # The kernel's batch is capped at the window, as the engine's top-k.
    capped = rounds.RoundsSpec(duration=DAY, max_rounds=64, window=4,
                               batch=BATCH)
    assert rsk.chain_barriers("fb", capped) == \
        3 + 8 * (17 + 4 * 2 + 2 * 4 + 1)


def test_coalesced_kernel_has_no_cpu_fallback():
    jobs = [Job(0, 0.0, size=1, runtime=10.0)]
    fb = SweepPoint("fb", capacity=4)
    with pytest.raises(ValueError, match="kernel=\"cuda\" needs CUDA"):
        run_sweep([fb], jobs, [(0.0, 0)], DAY, device="cpu",
                  scan_options=ScanOptions(coalesce=BATCH, kernel="cuda"))
    with pytest.raises(ValueError, match="kernel=\"cuda\" needs CUDA"):
        rounds.fb_rounds_row(jobs, [(0.0, 0)], 4, 3600.0, DAY,
                             kernel="cuda", batch=BATCH, device="cpu")
    # The wrapper itself refuses CPU tensors at any batch, uncounted.
    spec = rounds.RoundsSpec(duration=DAY, max_rounds=64, window=4,
                             batch=BATCH)
    pk = rounds.pack_event_workloads([(jobs, [(0.0, 0)])], DAY, 4, "fb",
                                     [3600.0], [4.0], device="cpu")
    grid = FBGrid(capacity=torch.tensor([4.0]),
                  lease=torch.tensor([3600.0]))
    prm = rounds._rounds_prm_tree("fb", grid, 1)
    ctx = rounds._lane_ctx("fb", prm, pk)
    sc, win = rounds._startup("fb", ctx, spec, pk.ws0[prm["w_idx"]])
    before = rsk.chunk_step.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rsk.chunk_step(*rsk.lane_inputs("fb", ctx), sc, win, policy="fb",
                       spec=spec)
    assert rsk.chunk_step.launches == before
