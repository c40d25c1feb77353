"""The port's chaos tier against the JAX package's.

* ``repro_torch.sim.faults`` (a copy) generates the reference's
  schedules, and its ``clamp`` / ``failed_series`` agree.
* ``pack_event_workloads(..., faults=)`` gives the reference's fault
  tables and fault-folded WS tables bit for bit.
* ``fb_rounds_row(..., faults=)`` equals the reference's ``kernel="xla"``
  row on ``tests/test_faults.py``'s chaos workload (capacity 12, one
  day), in float32 and float64, with coalescing off (batch 8 in
  ``test_torch_faults_coalesce.py``):
  every metric exact except the three built from time integrals
  (avg_turnaround, avg_execution, node_hours; rtol 1e-5 in float32,
  1e-6 in float64).
* The rows lie within ``FAULT_CONTRACT`` of the port's event engine,
  which loses no job.
* ``faults=None`` leaves the pack and the row what they are without
  faults, and the refusals are the reference's (FLB-NUB, a multi-level
  grid whose failures exceed its smallest capacity, the CUDA step).
"""

import numpy as np
import pytest
import torch

import jax

from repro.core.jobs import Job as RefJob
from repro.sim import faults as ref_faults
from repro.sim import rounds as ref_rounds
from repro_torch.core.jobs import Job
from repro_torch.kernels import round_step as rsk
from repro_torch.sim import faults, rounds
from repro_torch.sim.contracts import CONTRACTS, FAULT_CONTRACT, no_lost_jobs
from repro_torch.sim.engine import build_fb, clone_jobs, run_sim
from repro_torch.sim.scan import _lane_prm_tree

DAY = 24 * 3600.0
CAPACITY, LEASE = 12, 3600.0
INTEGRAL_METRICS = ("avg_turnaround", "avg_execution", "node_hours")
FIELDS = rounds._PACK_FIELDS + rounds._FAULT_FIELDS


def chaos_workload(seed=0, n=24, capacity=CAPACITY, horizon=DAY):
    """``tests/test_faults.py``'s ``_chaos_workload``, as the port's jobs
    and the reference's."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = [(float(rng.uniform(0, horizon * 0.7)),
             int(rng.integers(1, max(2, capacity // 3))),
             float(rng.uniform(600.0, horizon / 6))) for _ in range(n)]
    ws = [(float(t), int(rng.integers(0, capacity // 2 + 2)))
          for t in np.sort(rng.uniform(0, horizon, 10))]
    port = [Job(jid=i, submit=s, size=z, runtime=r)
            for i, (s, z, r) in enumerate(rows)]
    ref = [RefJob(jid=i, submit=s, size=z, runtime=r)
           for i, (s, z, r) in enumerate(rows)]
    return port, ref, ws


def chaos_schedule(mod, capacity=CAPACITY, horizon=DAY, mtbf_h=5.0):
    """``tests/test_faults.py``'s ``_chaos_schedule`` (MTBF 5 h) from
    ``mod`` (the port's ``faults`` or the reference's)."""
    return mod.merge_schedules(
        mod.exponential_schedule(seed=7, n_nodes=capacity // 2,
                                 mtbf=mtbf_h * 3600.0, mttr=1800.0,
                                 duration=horizon),
        mod.burst_schedule(seed=11, k=max(1, capacity // 4),
                           mtbf=2 * mtbf_h * 3600.0, mttr=3600.0,
                           duration=horizon))


def same_schedule(a, b):
    return (np.array_equal(a.times, b.times)
            and np.array_equal(a.deltas, b.deltas)
            and a.times.dtype == b.times.dtype
            and a.deltas.dtype == b.deltas.dtype)


# ----------------------------------------------------------- schedules

GENERATORS = {
    "exponential": lambda m: m.exponential_schedule(
        seed=3, n_nodes=8, mtbf=6 * 3600.0, mttr=1800.0, duration=DAY),
    "weibull": lambda m: m.weibull_schedule(
        seed=3, n_nodes=8, mtbf=6 * 3600.0, mttr=1800.0, duration=DAY,
        shape=1.5),
    "burst": lambda m: m.burst_schedule(
        seed=3, k=4, mtbf=8 * 3600.0, mttr=3600.0, duration=DAY),
    "merged": lambda m: chaos_schedule(m),
    "paper_scale": lambda m: m.merge_schedules(
        m.exponential_schedule(seed=7, n_nodes=67, mtbf=24 * 3600.0,
                               mttr=1800.0, duration=14 * DAY),
        m.burst_schedule(seed=11, k=33, mtbf=96 * 3600.0, mttr=3600.0,
                         duration=14 * DAY)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_schedule_generators_equal_reference(name):
    got, want = GENERATORS[name](faults), GENERATORS[name](ref_faults)
    assert len(got) > 0
    assert same_schedule(got, want)
    assert got.max_concurrent() == want.max_concurrent()
    for a, b in zip(got.failed_series(), want.failed_series()):
        assert np.array_equal(a, b)
    for cap in (1, 3, 6, 100):
        assert same_schedule(got.clamp(cap), want.clamp(cap)), cap
    assert list(got.events()) == list(want.events())


# ---------------------------------------------------------------- packs

def pack_both(policy, levels, schedules, dtype, workloads=None):
    """The port's pack (as numpy) and the reference's, of ``workloads``
    (default: the chaos workload twice, seeds 0 and 1) under
    ``schedules`` (one per workload, or None)."""
    if workloads is None:
        w0, w1 = chaos_workload(0), chaos_workload(1)
        workloads = ([(w0[0], w0[2]), (w1[0], w1[2])],
                     [(w0[1], w0[2]), (w1[1], w1[2])])
    leases = [LEASE] * len(levels)
    window = rounds.FB_ROUNDS_WINDOW
    port_f = ref_f = None
    if schedules is not None:
        port_f = [None if s is None else s(faults) for s in schedules]
        ref_f = [None if s is None else s(ref_faults) for s in schedules]
    port = rounds.pack_event_workloads(
        workloads[0], DAY, window, policy, leases, levels, dtype=dtype,
        faults=port_f, device="cpu")
    with jax.enable_x64(dtype == np.float64):
        ref = ref_rounds.pack_event_workloads(
            workloads[1], DAY, window, policy, leases, levels, dtype=dtype,
            faults=ref_f)
        ref = {k: (None if getattr(ref, k) is None
                   else np.asarray(getattr(ref, k)))
               for k in FIELDS}
    port = {k: (None if getattr(port, k) is None
                else getattr(port, k).numpy())
            for k in FIELDS}
    return port, ref


def assert_packs_equal(port, ref):
    for k in FIELDS:
        if ref[k] is None:
            assert port[k] is None, k
            continue
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_fault_tables_equal_reference(dtype):
    """One workload with the chaos schedule and one without (padded to
    the same fault axis), at one capacity level: the schedule clamps."""
    port, ref = pack_both("fb", [float(CAPACITY)],
                          [chaos_schedule, None], dtype)
    assert_packs_equal(port, ref)
    nf = port["fault_times"].shape[1]
    assert nf > 4 and np.isinf(port["fault_times"][1]).all()
    assert np.isinf(port["fault_times"][0, -1])        # the sentinel


def test_pack_multi_level_without_clamp_equals_reference():
    """A grid of levels shares one fault table when no level clamps."""
    sched = lambda m: m.burst_schedule(seed=3, k=2, mtbf=6 * 3600.0,
                                       mttr=3600.0, duration=DAY)
    port, ref = pack_both("fb", [8.0, 10.0, 12.0], [sched, sched],
                          np.float32)
    assert_packs_equal(port, ref)


def test_faults_none_leaves_the_pack_as_it_was():
    """faults=None, a list of None and an empty schedule all give the
    reference's pack without fault tables."""
    empty = lambda m: m.FaultSchedule(np.zeros(0), np.zeros(0, np.int64))
    base_port, base_ref = pack_both("fb", [float(CAPACITY)], None,
                                    np.float32)
    assert_packs_equal(base_port, base_ref)
    assert base_port["fault_times"] is None
    for schedules in ([None, None], [empty, None]):
        port, ref = pack_both("fb", [float(CAPACITY)], schedules,
                              np.float32)
        assert_packs_equal(port, base_ref)
        assert_packs_equal(ref, base_ref)


def test_from_reference_pack_takes_the_fault_tables():
    _, ref = pack_both("fb", [float(CAPACITY)], [chaos_schedule, None],
                       np.float32)
    pk = rounds.from_reference_pack(ref, device="cpu")
    for k in FIELDS:
        assert np.array_equal(getattr(pk, k).numpy(), ref[k]), k


def test_refusals_match_reference():
    w = chaos_workload(0)
    with pytest.raises(ValueError, match="FB-only"):
        rounds.pack_event_workloads(
            [(w[0], w[2])], DAY, rounds.FLB_ROUNDS_WINDOW, "flb_nub",
            [LEASE], [2.0], faults=[chaos_schedule(faults)], device="cpu")
    with pytest.raises(ValueError, match="FB-only"):
        ref_rounds.pack_event_workloads(
            [(w[1], w[2])], DAY, ref_rounds.FLB_ROUNDS_WINDOW, "flb_nub",
            [LEASE], [2.0], faults=[chaos_schedule(ref_faults)])
    # The chaos schedule reaches more concurrent failures than C = 2.
    assert chaos_schedule(faults).max_concurrent() > 2
    for mod, pack, jobs in ((faults, rounds.pack_event_workloads, w[0]),
                            (ref_faults, ref_rounds.pack_event_workloads,
                             w[1])):
        kw = {"device": "cpu"} if mod is faults else {}
        with pytest.raises(ValueError, match="smallest capacity level"):
            pack([(jobs, w[2])], DAY, rounds.FB_ROUNDS_WINDOW, "fb",
                 [LEASE, LEASE], [2.0, 12.0],
                 faults=[chaos_schedule(mod)], **kw)
        with pytest.raises(ValueError, match="must align"):
            pack([(jobs, w[2])] * 2, DAY, rounds.FB_ROUNDS_WINDOW, "fb",
                 [LEASE], [12.0], faults=[chaos_schedule(mod)], **kw)


# ----------------------------------------------------------------- rows

def assert_fault_row_equals_reference(dtype, batch):
    """The port's fault row against the reference's kernel="xla" row on
    the chaos workload (shared with test_torch_faults_coalesce.py)."""
    port_jobs, ref_jobs, ws = chaos_workload(0)
    port = rounds.fb_rounds_row(port_jobs, ws, CAPACITY, LEASE, DAY,
                                faults=chaos_schedule(faults), batch=batch,
                                dtype=dtype, device="cpu")
    with jax.enable_x64(dtype == np.float64):
        ref = ref_rounds.fb_rounds_row(ref_jobs, ws, CAPACITY, LEASE, DAY,
                                       faults=chaos_schedule(ref_faults),
                                       kernel="xla", batch=batch,
                                       dtype=dtype)
    assert set(port) == set(ref)
    rtol = 1e-5 if dtype == np.float32 else 1e-6
    for k, v in ref.items():
        if k in INTEGRAL_METRICS:
            assert port[k] == pytest.approx(v, rel=rtol), k
        else:
            assert port[k] == v, k
    assert port["kills"] > 0 and port["truncated"] == 0.0
    if batch > 1:
        assert port["coalesced"] > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fault_row_equals_reference_xla_row(dtype):
    """Coalescing off (the engine's default batch 1); batch 8 is in
    test_torch_faults_coalesce.py."""
    assert_fault_row_equals_reference(dtype, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_fault_rows_within_contract_of_event_engine(seed):
    port_jobs, _, ws = chaos_workload(seed)
    sched = chaos_schedule(faults)
    sys_ = build_fb(CAPACITY, LEASE)
    ev_jobs = clone_jobs(port_jobs)
    ev = run_sim(sys_, ev_jobs, ws, duration=DAY, name="event",
                 faults=sched)
    rr = rounds.fb_rounds_row(port_jobs, ws, CAPACITY, LEASE, DAY,
                              faults=sched, device="cpu")
    assert FAULT_CONTRACT.check_row(rr, ev.row()) == []
    assert CONTRACTS["faults"] is FAULT_CONTRACT
    assert no_lost_jobs(ev_jobs, sys_) == []


def test_faults_none_row_is_the_row_without_faults():
    port_jobs, _, ws = chaos_workload(0)
    plain = rounds.fb_rounds_row(port_jobs, ws, CAPACITY, LEASE, DAY,
                                 device="cpu")
    assert rounds.fb_rounds_row(port_jobs, ws, CAPACITY, LEASE, DAY,
                                faults=None, device="cpu") == plain
    ev = run_sim(build_fb(CAPACITY, LEASE), clone_jobs(port_jobs), ws,
                 duration=DAY, name="event")
    assert plain["completed_jobs"] == ev.completed_jobs
    assert plain["node_hours"] == pytest.approx(ev.node_hours, rel=1e-5)
    assert plain["peak_nodes"] == ev.peak_nodes


# -------------------------------------------------------------- routing

def test_fault_pack_routes_to_the_plain_step():
    """kernel=None resolves to "torch" for a fault pack on any device;
    "cuda" refuses it with the reference's message, and so do the two
    kernel wrappers when handed a fault table (before any launch)."""
    spec = rounds.RoundsSpec(duration=DAY, max_rounds=64,
                             window=rounds.FB_ROUNDS_WINDOW)
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert spec.resolve_kernel(dev, True) == "torch"
    assert spec.resolve_kernel(torch.device("cuda")) == "cuda"
    cuda = rounds.RoundsSpec(duration=DAY, max_rounds=64,
                             window=rounds.FB_ROUNDS_WINDOW, kernel="cuda")
    with pytest.raises(NotImplementedError, match="fault injection"):
        cuda.resolve_kernel(torch.device("cuda"), True)
    port_jobs, _, ws = chaos_workload(0)
    with pytest.raises(NotImplementedError, match="fault injection"):
        rounds.fb_rounds_row(port_jobs, ws, CAPACITY, LEASE, DAY,
                             faults=chaos_schedule(faults), kernel="cuda",
                             device="cpu")
    ftab = torch.zeros(1, 3, 1)
    before = (rsk.chunk_step.launches, rsk.run_rounds.launches)
    with pytest.raises(NotImplementedError, match="fault injection"):
        rsk.chunk_step(None, None, None, None, None, None, policy="fb",
                       spec=spec, ftab=ftab)
    with pytest.raises(NotImplementedError, match="fault injection"):
        rsk.run_rounds(None, None, None, None, None, None, policy="fb",
                       spec=spec, outer_max=1, ftab=ftab)
    assert (rsk.chunk_step.launches, rsk.run_rounds.launches) == before


def test_lane_inputs_check_the_fault_table():
    port_jobs, _, ws = chaos_workload(0)
    pk = rounds.pack_event_workloads(
        [(port_jobs, ws)], DAY, rounds.FB_ROUNDS_WINDOW, "fb", [LEASE],
        [float(CAPACITY)], faults=[chaos_schedule(faults)], device="cpu")
    grid = rounds.FBGrid(capacity=torch.tensor([float(CAPACITY)]),
                         lease=torch.tensor([LEASE]))
    ctx = rounds._lane_ctx("fb", _lane_prm_tree("fb", grid, 1), pk)
    ftab = rsk.fault_table(ctx)
    assert ftab.shape == (1, 3, pk.fault_times.shape[1])
    inputs = rsk.lane_inputs("fb", ctx, ftab)
    back = rsk._ctx_from_inputs("fb", *inputs, ftab)
    for k in ("fault_times", "fault_failed", "fault_wsv"):
        assert torch.equal(back[k], ctx[k]) and back[k].is_contiguous()
    with pytest.raises(TypeError, match="ftab"):
        rsk.lane_inputs("fb", ctx, ftab.double())
    with pytest.raises(ValueError, match="ftab"):
        rsk.lane_inputs("fb", ctx, ftab[:, :2].contiguous())
    no_fault = {k: v for k, v in ctx.items() if not k.startswith("fault")}
    assert rsk.fault_table(no_fault) is None
