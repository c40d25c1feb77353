"""The sweep's lane splitter (``devices=``), the counterpart of
``tests/test_sweep_sharded.py``.

The reference forces two XLA host devices in a subprocess; the port
drives its splitter with a device list that names the CPU more than
once (``compat.resolve_devices``): each shard gets its own pack and
parameter tree and runs the single-device program, one shard after the
other. So every row must equal the ``devices=None`` row bit for bit:

* the odd-lane case of the reference (3 workloads × 3 points, 2 days)
  under ``["cpu", "cpu"]`` and ``["cpu"] * 3``, in ``mode="scan"``,
  ``"rounds"`` and coalesced ``"rounds"`` (each pads lanes, which must
  be dropped), and the coalesced rows really coalesce;
* ``devices=1`` and a one-element list are the plain path, ``0`` / ``-1``
  raise, an int beyond the visible cards raises, a fault pack refuses
  the splitter with the reference's message;
* the sharded scan rows equal the JAX package's single-device
  ``scan_grids`` rows (counts exact, time integrals within rtol 1e-5 in
  float32, as in ``tests/test_torch_scan_engine.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.sim import scan as ref
from repro.sim import traces as ref_traces
from repro_torch import compat
from repro_torch.core.jobs import Job
from repro_torch.core.pbj_manager import PBJPolicyParams
from repro_torch.sim import faults, rounds, scan, traces
from repro_torch.sim.sweep import (ScanOptions, SweepPoint, run_sweep,
                                   run_sweep_workloads)

T = 2 * 24 * 3600.0
MODES = {"scan": ("scan", ScanOptions()),
         "rounds": ("rounds", ScanOptions()),
         "rounds_coalesced": ("rounds", ScanOptions(coalesce=8))}
DEVICE_LISTS = {"two": ["cpu", "cpu"], "three": ["cpu"] * 3}


def _cut(jobs):
    return [j for j in jobs if j.submit < T]


def _cutws(ws):
    return [(t, d) for t, d in ws if t < T]


@pytest.fixture(scope="module")
def odd_lanes():
    """The reference test's workloads and points: 3 × 3 lanes a policy,
    which no device count of 2 or 3 divides into whole lanes for every
    engine (rounds runs 3 lanes a workload, scan 9 a policy)."""
    wls = [(_cut(traces.nasa_ipsc(seed=3)),
            _cutws(traces.worldcup98(seed=3, peak_vms=64))),
           (_cut(traces.sdsc_blue(seed=3)),
            _cutws(traces.worldcup98(seed=4, peak_vms=64))),
           (_cut(traces.nasa_ipsc(seed=5)),
            _cutws(traces.worldcup98(seed=5, peak_vms=64)))]
    pts = ([SweepPoint("fb", capacity=c) for c in (96, 128, 160)]
           + [SweepPoint("flb_nub", lb_pbj=B - 12, lb_ws=12)
              for B in (25, 51, 102)]
           + [SweepPoint("ec2", lease_seconds=3600.0)])
    single = {name: run_sweep_workloads(pts, wls, T, mode=mode,
                                        scan_options=opts, device="cpu")
              for name, (mode, opts) in MODES.items()}
    return wls, pts, single


def _diff(a, b):
    return [(w, i, x, y) for w, (ra, rb) in enumerate(zip(a, b))
            for i, (x, y) in enumerate(zip(ra, rb)) if x != y][:3]


@pytest.mark.parametrize("devs", sorted(DEVICE_LISTS))
@pytest.mark.parametrize("mode_name", sorted(MODES))
def test_sharded_matches_single_device_on_odd_lane_count(odd_lanes,
                                                         mode_name, devs):
    wls, pts, single = odd_lanes
    mode, opts = MODES[mode_name]
    got = run_sweep_workloads(pts, wls, T, mode=mode, scan_options=opts,
                              devices=DEVICE_LISTS[devs], device="cpu")
    assert got == single[mode_name], _diff(single[mode_name], got)
    assert all(r["engine"] == mode for row in got for r in row[:-1])
    if opts.coalesce:
        assert sum(r.get("coalesced", 0) for row in got for r in row) > 0


def test_devices_one_is_the_plain_single_device_path():
    assert compat.resolve_devices(None) is None
    assert compat.resolve_devices(1) is None
    assert compat.resolve_devices(["cpu"]) is None
    assert compat.resolve_devices([torch.device("cpu")] * 2) == \
        [torch.device("cpu")] * 2
    for bad in (0, -1):
        with pytest.raises(ValueError, match="devices must be >= 1"):
            compat.resolve_devices(bad)
    T12 = 12 * 3600.0
    jobs = [j for j in traces.nasa_ipsc(seed=3) if j.submit < T12]
    ws = [(t, d) for t, d in traces.worldcup98(seed=3, peak_vms=64)
          if t < T12]
    pts = [SweepPoint("fb", capacity=64),
           SweepPoint("flb_nub", lb_pbj=13, lb_ws=12)]
    plain = run_sweep(pts, jobs, ws, T12, mode="scan", device="cpu")
    for devs in (1, ["cpu"]):
        assert run_sweep(pts, jobs, ws, T12, mode="scan", devices=devs,
                         device="cpu") == plain


def test_devices_request_beyond_visible_raises():
    """An int asks for cards, and never shrinks to the visible ones."""
    T12 = 12 * 3600.0
    jobs = [j for j in traces.nasa_ipsc(seed=3) if j.submit < T12]
    ws = [(t, d) for t, d in traces.worldcup98(seed=3, peak_vms=64)
          if t < T12]
    too_many = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        run_sweep([SweepPoint("fb", capacity=64)], jobs, ws, T12,
                  mode="scan", devices=max(2, too_many), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            compat.resolve_devices(["cpu", "cuda:0"])


def test_fault_pack_refuses_the_splitter():
    rng = np.random.Generator(np.random.PCG64(0))
    jobs = [Job(jid=i, submit=float(rng.uniform(0, 6e4)), size=2,
                runtime=3600.0) for i in range(12)]
    ws = [(0.0, 2), (3e4, 4)]
    day = 24 * 3600.0
    sched = faults.exponential_schedule(seed=7, n_nodes=6, mtbf=5 * 3600.0,
                                        mttr=1800.0, duration=day)
    spec = rounds.RoundsSpec(duration=day, max_rounds=256,
                             window=rounds.FB_ROUNDS_WINDOW)
    pk = rounds.pack_event_workloads([(jobs, ws)], day, spec.window, "fb",
                                     [3600.0], [12.0], faults=[sched],
                                     device="cpu")
    f = pk.submit.dtype
    fb = scan.FBGrid(capacity=torch.tensor([12.0], dtype=f),
                     lease=torch.tensor([3600.0], dtype=f))
    with pytest.raises(NotImplementedError, match="single-device"):
        rounds.rounds_grids(fb, None, pk, None, fb_spec=spec,
                            devices=["cpu", "cpu"])
    # One device runs it (the plain step).
    out = rounds.rounds_grids(fb, None, pk, None, fb_spec=spec,
                              devices=["cpu"])
    assert out["fb"]["completed_jobs"].shape == (1, 1)


def test_sharded_scan_rows_equal_reference_scan():
    """Two 2-day workloads (the first 120 jobs, sizes capped at 16) × 2
    FB and 3 FLB-NUB points: the reference's single-device
    ``scan_grids`` against the port's split over three CPU shards (4 FB
    lanes pad 2, 6 FLB-NUB lanes pad 0)."""
    from repro.core.jobs import Job as RefJob

    def bench_cut(jobs, seed):
        cut = [RefJob(jid=i, submit=j.submit, size=min(j.size, 16),
                      runtime=j.runtime)
               for i, j in enumerate(j for j in jobs if j.submit < T * 0.6)]
        return cut[:120], ref_traces.worldcup98(seed=seed, peak_vms=16,
                                                duration=T)

    wls = [bench_cut(ref_traces.nasa_ipsc(seed=0), 0),
           bench_cut(ref_traces.sdsc_blue(seed=0), 1)]
    fb_pts = ((24.0, 3600.0), (32.0, 3600.0))
    flb_pts = ((25.0, 12.0, 3600.0), (25.0, 12.0, 1800.0),
               (13.0, 12.0, 3600.0))
    prm = PBJPolicyParams()
    U, V, G = (prm.request_threshold, prm.release_threshold,
               prm.elastic_factor)

    def grids(lib, mk):
        return (lib.FBGrid(capacity=mk([c for c, _ in fb_pts]),
                           lease=mk([L for _, L in fb_pts])),
                lib.FLBGrid(B=mk([b for b, _, _ in flb_pts]),
                            lb_ws=mk([w for _, w, _ in flb_pts]),
                            U=mk([U] * 3), V=mk([V] * 3), G=mk([G] * 3),
                            lease=mk([L for _, _, L in flb_pts])))

    def spec(lib, policy, leases, ws):
        dt = lib.pick_dt(policy, leases, ws, T)
        chunk = max(2, int(round((3600.0 if policy == "fb" else 1800.0)
                                 / dt)))
        return lib.ScanSpec(n_steps=int(np.ceil(T / dt)), dt=dt,
                            window=lib.FB_WINDOW if policy == "fb"
                            else lib.FLB_WINDOW, chunk_len=chunk,
                            ff_passes=lib.DEFAULT_FF_PASSES)

    def specs(lib):
        return (spec(lib, "fb", [L for _, L in fb_pts], None),
                spec(lib, "flb_nub", [L for _, _, L in flb_pts],
                     [ws for _, ws in wls]))

    r_specs = specs(ref)
    want = ref.scan_grids(
        *grids(ref, lambda v: jnp.asarray(v, jnp.float32)),
        *[ref.pack_workloads(wls, T, s.dt, window=s.window,
                             chunk_len=s.chunk_len)[0] for s in r_specs],
        fb_spec=r_specs[0], flb_spec=r_specs[1])
    p_specs = specs(scan)
    packs = [scan.pack_workloads(wls, T, s.dt, window=s.window,
                                 chunk_len=s.chunk_len, device="cpu")[0]
             for s in p_specs]
    fb, flb = grids(scan, lambda v: torch.tensor(v, dtype=torch.float32))
    got = scan.scan_grids(fb, flb, *packs, fb_spec=p_specs[0],
                          flb_spec=p_specs[1], devices=["cpu"] * 3)
    plain = scan.scan_grids(fb, flb, *packs, fb_spec=p_specs[0],
                            flb_spec=p_specs[1])
    for policy in ("fb", "flb_nub"):
        for k, a in want[policy].items():
            a, b = np.asarray(a), got[policy][k].numpy()
            assert a.shape == b.shape, (policy, k)
            np.testing.assert_array_equal(b, plain[policy][k].numpy())
            if k in ("avg_turnaround", "avg_execution", "node_hours"):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=0,
                                           err_msg=f"{policy} {k}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{policy} {k}")
    assert float(got["fb"]["kills"].sum()) > 0


def test_shards_on_distinct_devices_run_on_their_own_threads():
    """One host thread per distinct device, a device's shards in turn,
    results in shard order, and a shard's error raised on the caller's
    thread."""
    import threading
    import time
    cpu, meta = torch.device("cpu"), torch.device("meta")
    seen = []

    def job(i):
        def run():
            time.sleep(0.01)
            seen.append((i, threading.get_ident()))
            return i
        return run

    jobs = [(cpu, job(0)), (meta, job(1)), (cpu, job(2)), (meta, job(3))]
    assert scan._run_shards(jobs) == [0, 1, 2, 3]
    threads = dict(seen)
    assert threads[0] == threads[2] and threads[1] == threads[3]
    assert threads[0] != threads[1] != threading.get_ident()
    order = [i for i, _ in seen]
    assert order.index(0) < order.index(2) and order.index(1) < \
        order.index(3)

    def boom():
        raise RuntimeError("shard failed")

    with pytest.raises(RuntimeError, match="shard failed"):
        scan._run_shards([(cpu, job(0)), (meta, boom)])
