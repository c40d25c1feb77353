"""The port's FLB-NUB tick simulator (``repro_torch.core.jaxsim``, plain
version ``kernels.jaxsim_step.simulate_ref``) against the JAX package's
``repro.core.jaxsim``, on the CPU.

* ``pack_trace`` arrays and ``n_steps`` equal the reference's, float32
  and float64 (the reference under ``jax.enable_x64(True)``);
* ``simulate`` equals the reference's vmapped ``simulate`` on 2-day cuts
  of the NASA and SDSC traces at points that reach B 154, U 2.0, V 0.5
  and G 0.99, float32 and float64 (the reference under x64, with the
  float32 parameters promoted, as its ``sweep`` builds them);
* the §6.6.4 study (``benchmarks/tables.py``'s 12 points, two weeks)
  equals the reference's ``sweep`` and ``results/tables.json``;
* the jump first-fit equals a literal sequential first-fit (hypothesis);
* the reference's fidelity band and paper trends hold against the
  port's own event engine;
* ``device=None`` raises without CUDA, ``impl`` resolves as documented.

Tolerances: completed jobs, peak nodes, adjust events and node-hours
exactly (every sum they read is of integer values); ``avg_turnaround``
within rtol 1e-5 (float32) or 1e-6 (float64), since the turnaround sum
is taken in another order than XLA's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import jaxsim as ref
from repro.sim import traces as ref_traces
from repro_torch import compat
from repro_torch.core import jaxsim
from repro_torch.kernels import jaxsim_step
from repro_torch.sim import traces
from repro_torch.sim.engine import build_flb_nub, clone_jobs, run_sim

ROOT = Path(__file__).resolve().parents[1]
DAY = 24 * 3600.0
CUT = 2 * DAY
RTOL = {np.float32: 1e-5, np.float64: 1e-6}
EXACT = ("completed_jobs", "peak_nodes", "adjust_events", "node_hours")
# benchmarks/tables.py's jaxsim_sweep grid (§6.6.4).
STUDY = ([{"B": b, "U": 1.2, "V": 0.2, "G": 0.5}
          for b in (13, 25, 51, 102, 154)]
         + [{"B": 25, "U": u, "V": 0.2, "G": 0.5} for u in (1.0, 1.5, 2.0)]
         + [{"B": 25, "U": 1.2, "V": v, "G": 0.5} for v in (0.1, 0.5)]
         + [{"B": 25, "U": 1.2, "V": 0.2, "G": g} for g in (0.25, 0.99)])
# 2-day points: the study's extremes, and their combinations.
POINTS = [{"B": 154, "U": 2.0, "V": 0.5, "G": 0.99},
          {"B": 25, "U": 1.2, "V": 0.2, "G": 0.5},
          {"B": 13, "U": 1.0, "V": 0.5, "G": 0.99},
          {"B": 51, "U": 2.0, "V": 0.1, "G": 0.25},
          {"B": 102, "U": 1.5, "V": 0.5, "G": 0.99}]


def _trace(name):
    jobs = {"nasa": traces.nasa_ipsc, "sdsc": traces.sdsc_blue}[name](0)
    return jobs, traces.worldcup98(0, peak_vms=128)


def _cut(name):
    jobs, ws = _trace(name)
    return [j for j in jobs if j.submit < CUT], ws


def assert_rows(got, want, dtype, label=""):
    """``got`` / ``want``: dicts of per-lane arrays (or row lists)."""
    for k in EXACT:
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(want[k], np.float64),
                                      err_msg=f"{label} {k}")
    np.testing.assert_allclose(np.asarray(got["avg_turnaround"], np.float64),
                               np.asarray(want["avg_turnaround"],
                                          np.float64),
                               rtol=RTOL[dtype], atol=0,
                               err_msg=f"{label} avg_turnaround")


def _columns(rows):
    return {k: [r[k] for r in rows] for k in rows[0]}


def _ref_simulate(points, jobs, ws, dtype):
    """The reference's vmapped simulate; float64 under x64 with the
    float32 parameters promoted."""
    def run():
        packed = ref.pack_trace(jobs, ws, CUT, 3600.0, dtype=dtype)
        sub, sz, rt, w, n = packed
        params = ref.FLBNUBParams(**{
            k: jnp.asarray(np.array([p[k] for p in points], np.float32)
                           .astype(dtype)) for k in "BUVG"})
        out = jax.vmap(lambda pr: ref.simulate(
            pr, sub, sz, rt, w, n_steps=n, lease_seconds=3600.0))(params)
        return {k: np.asarray(v) for k, v in out.items()}

    if dtype == np.float64:
        with jax.enable_x64(True):
            return run()
    return run()


# ------------------------------------------------------------ pack_trace

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["nasa", "sdsc"])
def test_pack_trace_equals_reference(name, dtype):
    jobs, ws = _cut(name)
    got = jaxsim.pack_trace(jobs, ws, CUT, 3600.0, dtype=dtype, device="cpu")
    with jax.enable_x64(dtype == np.float64):
        want = ref.pack_trace(jobs, ws, CUT, 3600.0, dtype=dtype)
        want = [np.asarray(a) for a in want[:4]] + [want[4]]
    assert got[4] == want[4] == 576
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_array_equal(g.numpy(), w)


def test_pack_trace_default_dtype_and_refusals():
    jobs, ws = _cut("nasa")
    packed = jaxsim.pack_trace(jobs[:8], ws, 7200.0, 3600.0, device="cpu")
    assert packed[0].dtype == torch.float32 and packed[4] == 24
    with pytest.raises(ValueError, match="float32 or float64"):
        jaxsim.pack_trace(jobs[:8], ws, 7200.0, 3600.0, dtype=np.float16,
                          device="cpu")


# -------------------------------------------------------------- simulate

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["nasa", "sdsc"])
def test_simulate_equals_reference_on_a_two_day_cut(name, dtype):
    jobs, ws = _cut(name)
    want = _ref_simulate(POINTS, jobs, ws, dtype)
    packed = jaxsim.pack_trace(jobs, ws, CUT, 3600.0, dtype=dtype,
                               device="cpu")
    params = jaxsim.FLBNUBParams(**{
        k: torch.tensor([p[k] for p in POINTS], dtype=torch.float32)
        for k in "BUVG"})
    got = jaxsim.simulate(params, *packed[:4], packed[4], 3600.0,
                          device="cpu")
    assert got["avg_turnaround"].dtype == getattr(torch,
                                                  np.dtype(dtype).name)
    assert got["adjust_events"].dtype == torch.float32
    assert_rows({k: v.numpy() for k, v in got.items()}, want, dtype, name)
    # every point adjusts its allocation inside the cut
    assert (want["adjust_events"] > 0).all()


def test_simulate_scalar_params_give_scalar_outputs():
    jobs, ws = _cut("nasa")
    packed = jaxsim.pack_trace(jobs, ws, CUT, 3600.0, device="cpu")
    one = jaxsim.FLBNUBParams(*(torch.tensor(float(POINTS[0][k]))
                                for k in "BUVG"))
    got = jaxsim.simulate(one, *packed[:4], packed[4], 3600.0, device="cpu")
    assert all(v.dim() == 0 for v in got.values())
    want = _ref_simulate(POINTS[:1], jobs, ws, np.float32)
    assert_rows({k: v.numpy()[None] for k, v in got.items()}, want,
                np.float32)


@pytest.fixture(scope="module")
def study():
    """The §6.6.4 study through the port's plain version (two weeks)."""
    jobs, ws = _trace("nasa")
    return jaxsim.sweep(STUDY, jobs, ws, traces.TWO_WEEKS, device="cpu")


def test_study_equals_reference_sweep_and_recorded_table(study):
    jobs = ref_traces.nasa_ipsc(0)
    ws = ref_traces.worldcup98(0, peak_vms=128)
    want = ref.sweep(STUDY, jobs, ws, ref_traces.TWO_WEEKS)
    assert [{k: r[k] for k in "BUVG"} for r in study] == STUDY
    assert_rows(_columns(study), _columns(want), np.float32, "reference")
    recorded = json.loads((ROOT / "results" / "tables.json").read_text())[
        "jaxsim_sweep"]
    assert_rows(_columns(study), _columns(recorded), np.float32, "tables")


# -------------------------------------------------------------- first-fit

def _sequential_first_fit(queued, size, free):
    """The reference's inner scan, literally: one job at a time."""
    starts = np.zeros_like(queued)
    for lane in range(queued.shape[0]):
        fr = np.float32(free[lane])
        for i in range(queued.shape[1]):
            if queued[lane, i] and size[lane, i] <= fr:
                starts[lane, i] = True
                fr = np.float32(fr - size[lane, i])
    return starts


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 4), st.integers(1, 40), st.data())
def test_jump_first_fit_equals_sequential_scan(lanes, jobs, data):
    sizes = st.sampled_from([1.0, 2.0, 3.0, 8.0, 8.0, 16.0, 0.5, 128.0])
    size = np.array(data.draw(st.lists(st.lists(
        sizes, min_size=jobs, max_size=jobs), min_size=lanes,
        max_size=lanes)), np.float32)
    queued = np.array(data.draw(st.lists(st.lists(
        st.booleans(), min_size=jobs, max_size=jobs), min_size=lanes,
        max_size=lanes)))
    free = np.array(data.draw(st.lists(st.sampled_from(
        [-3.0, -0.5, 0.0, 0.5, 1.0, 7.0, 16.0, 40.0, 1e4]),
        min_size=lanes, max_size=lanes)), np.float32)
    got = jaxsim_step.first_fit(torch.from_numpy(queued),
                                torch.from_numpy(size),
                                torch.from_numpy(free))
    np.testing.assert_array_equal(got.numpy(),
                                  _sequential_first_fit(queued, size, free))


def test_jump_first_fit_shared_size_column():
    queued = torch.tensor([[True, True, False, True, True]] * 2)
    size = torch.tensor([4.0, 2.0, 1.0, 2.0, 1.0])
    got = jaxsim_step.first_fit(queued, size, torch.tensor([5.0, -1.0]))
    assert got.tolist() == [[True, False, False, False, True],
                            [False] * 5]


# ------------------------------------------- fidelity and the paper trends

def _row(study, **kw):
    """The study's row at the paper's point with ``kw`` changed."""
    point = {"B": 25, "U": 1.2, "V": 0.2, "G": 0.5, **kw}
    return next(r for r in study if all(r[k] == v for k, v in point.items()))


def test_fidelity_vs_event_sim(study):
    """``tests/test_jaxsim.py``'s band, against the port's event engine:
    completed within 2, node-hours and peak within 15 %."""
    jobs, ws = _trace("nasa")
    ev = run_sim(build_flb_nub(13, 12), clone_jobs(jobs), ws,
                 traces.TWO_WEEKS)
    out = _row(study)
    assert abs(out["completed_jobs"] - ev.completed_jobs) <= 2
    assert abs(out["node_hours"] - ev.node_hours) / ev.node_hours < 0.15
    assert abs(out["peak_nodes"] - ev.peak_nodes) / ev.peak_nodes < 0.15


def test_paper_trends(study):
    """J1 (Fig 14): consumption grows and turnaround falls with B;
    §6.6.4: turnaround grows with G."""
    b = [_row(study, B=x) for x in (13, 51, 154)]
    g = [_row(study, G=x) for x in (0.25, 0.99)]
    assert b[0]["node_hours"] < b[1]["node_hours"] < b[2]["node_hours"]
    assert b[0]["avg_turnaround"] > b[2]["avg_turnaround"]
    assert g[0]["avg_turnaround"] < g[1]["avg_turnaround"]
    assert all(r["completed_jobs"] >= 2600 for r in b + g)


# ------------------------------------------------------ devices and impls

def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs, ws = _cut("nasa")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        jaxsim.sweep(POINTS[:1], jobs, ws, CUT)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        jaxsim.pack_trace(jobs, ws, CUT, 3600.0)


def test_impl_resolution_and_kernel_refuses_cpu_tensors():
    cpu = torch.device("cpu")
    assert compat.resolve_backend(None, cpu) == "torch"
    assert compat.resolve_backend("torch", cpu) == "torch"
    assert compat.resolve_backend(None, torch.device("cuda", 0)) == "cuda"
    assert compat.resolve_backend("torch", torch.device("cuda", 0)) == \
        "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        compat.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="impl"):
        compat.resolve_backend("pallas", cpu)
    with pytest.raises(ValueError, match="impl=\"cuda\" needs CUDA"):
        jaxsim.sweep(POINTS[:1], *_cut("nasa"), CUT, device="cpu",
                     impl="cuda")
    jobs, ws = _cut("nasa")
    packed = jaxsim.pack_trace(jobs, ws, CUT, 3600.0, device="cpu")
    prm = torch.tensor([[25.0, 1.2, 0.2, 0.5]])
    with pytest.raises(ValueError, match="simulate_ref"):
        jaxsim_step.simulate_kernel(prm, *packed[:4], n_steps=packed[4],
                                    lease_seconds=3600.0)
