"""The port's round step against the JAX package's, after every chunk.

``repro_torch.kernels.round_step.chunk_step_ref`` (the plain PyTorch
version of the CUDA kernel, which has no CPU mode) must
equal the reference Pallas kernel ``repro.kernels.round_step.chunk_step``
run in interpret mode — the way the JAX package's own tests run it — and
the reference's unfused ``chunk_step_ref``, on the packed state after
EVERY chunk of a simulation: FB and FLB-NUB, coalescing off and on
(batch 1 and 8), float32 and float64. Each chunk starts both sides from
the same state; every field must be equal except the three
order-dependent time integrals (turn_sum, exec_sum, node_seconds), held
at rtol 1e-5 in float32 and 1e-6 in float64.

The lanes are two sweep points on a two-day NASA iPSC + WorldCup slice
with a K = 16 window (as the reference's kernel test uses), so the
compaction and the table-end clamp run often.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import round_step as ref_rsk
from repro.sim import rounds as ref_rounds
from repro.sim import traces as ref_traces
from repro_torch.kernels import round_step as rsk
from repro_torch.sim import rounds
from repro_torch.sim.scan import FBGrid, FLBGrid, _lane_prm_tree

DAY = 24 * 3600.0
K = 16
HORIZON = 2 * DAY
RTOL = {np.float32: 1e-5, np.float64: 1e-6}
INTEGRALS = [rsk.SC_ACC0 + rounds.ACC_KEYS.index(k)
             for k in ("turn_sum", "exec_sum", "node_seconds")]
# Two points per policy: FB (C, L) and FLB-NUB (B, lb_ws, L).
POINTS = {"fb": [(24.0, 3600.0), (40.0, 1800.0)],
          "flb_nub": [(25.0, 12.0, 3600.0), (51.0, 12.0, 900.0)]}


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


def _workload(seed=0):
    jobs = [j for j in ref_traces.nasa_ipsc(seed=seed) if j.submit < HORIZON]
    ws = [(t, d) for t, d in ref_traces.worldcup98(seed=seed, peak_vms=64)
          if t < HORIZON]
    return jobs, ws


def port_lanes(policy, dtype, batch):
    """The port's lanes from the reference pack's arrays: its grid, spec,
    kernel inputs and startup state."""
    jobs, ws = _workload()
    pts = POINTS[policy]
    leases = [p[-1] for p in pts]
    levels = [p[0] if policy == "fb" else p[1] for p in pts]
    with _x64(dtype):
        pk_ref = ref_rounds.pack_event_workloads(
            [(jobs, ws)], HORIZON, K, policy, leases, levels, dtype=dtype)
        arrays = {k: np.asarray(getattr(pk_ref, k))
                  for k in rounds._PACK_FIELDS}
    pk = rounds.from_reference_pack(arrays, device="cpu")
    f = pk.submit.dtype
    col = [torch.tensor(c, dtype=f) for c in zip(*pts)]
    if policy == "fb":
        grid = FBGrid(capacity=col[0], lease=col[1])
    else:
        grid = FLBGrid(B=col[0], lb_ws=col[1],
                       U=torch.full((2,), 0.25, dtype=f),
                       V=torch.full((2,), 0.5, dtype=f),
                       G=torch.full((2,), 2.0, dtype=f), lease=col[2])
    spec = rounds.RoundsSpec(duration=HORIZON, max_rounds=4096, window=K,
                             batch=batch, kernel="torch")
    prm = _lane_prm_tree(policy, grid, 1)
    ctx = rounds._lane_ctx(policy, prm, pk)
    sc, win = rounds._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    return rsk.lane_inputs(policy, ctx), sc, win, spec


def ref_steps(policy, spec):
    """jit(vmap) of the reference Pallas kernel (interpret mode) and of
    its unfused reference, over the lane axis."""
    rspec = ref_rounds.RoundsSpec(duration=spec.duration,
                                  max_rounds=spec.max_rounds, window=K,
                                  batch=spec.batch, kernel="pallas")

    def make(fn):
        return jax.jit(jax.vmap(lambda j, r, w, p, s, wi: fn(
            j, r, w, p, s, wi, policy=policy, spec=rspec, interpret=True)))
    return make(ref_rsk.chunk_step), make(ref_rsk.chunk_step_ref)


def assert_state_equal(ref, port, dtype, label):
    sc_r, win_r = (np.asarray(a) for a in ref)
    sc_p, win_p = (a.numpy() for a in port)
    assert sc_r.dtype == sc_p.dtype == dtype, label
    np.testing.assert_array_equal(win_r, win_p, err_msg=f"{label} window")
    exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRALS]
    np.testing.assert_array_equal(sc_r[:, exact], sc_p[:, exact],
                                  err_msg=f"{label} scalars")
    np.testing.assert_allclose(sc_r[:, INTEGRALS], sc_p[:, INTEGRALS],
                               rtol=RTOL[dtype], atol=0,
                               err_msg=f"{label} integrals")


def run_against_reference(policy, batch, dtype):
    """Step the port and both reference steps chunk by chunk from the
    same state until every lane reaches the horizon."""
    inputs, sc, win, spec = port_lanes(policy, dtype, batch)
    dur = torch.tensor(HORIZON, dtype=sc.dtype)
    with _x64(dtype):
        fused, unfused = ref_steps(policy, spec)
        inputs_j = [jnp.asarray(x.numpy()) for x in inputs]
        chunks = 0
        while bool((sc[:, rsk.SC_T] < dur).any()):
            assert chunks < 1024, "lanes never reached the horizon"
            args = inputs_j + [jnp.asarray(sc.numpy()),
                               jnp.asarray(win.numpy())]
            port = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                      spec=spec)
            label = (policy, batch, dtype.__name__, chunks)
            assert_state_equal(fused(*args), port, dtype, ("pallas",) + label)
            assert_state_equal(unfused(*args), port, dtype, ("xla",) + label)
            live = sc[:, rsk.SC_T] < dur
            sc = torch.where(live[:, None], port[0], sc)
            win = torch.where(live[:, None, None], port[1], win)
            chunks += 1
    acc = sc[:, rsk.SC_ACC0:]
    assert chunks > 20 and bool((acc[:, 0] > 0).all())   # jobs completed
    if batch > 1:
        assert bool((acc[:, rounds.ACC_KEYS.index("coalesced")] > 0).any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_chunk_step_matches_reference_after_every_chunk(policy, dtype):
    """Coalescing off (the engine's default batch 1). The coalescer's
    cases are in test_torch_round_step_coalesce_*.py."""
    run_against_reference(policy, 1, dtype)


def test_pack_roundtrip_and_cpu_wrapper():
    """The (sc, win) pack round-trips exactly, and on CPU tensors the
    kernel wrapper raises without counting a launch (the CPU runs the
    plain version through RoundsSpec.kernel, never through chunk_step)."""
    inputs, sc, win, spec = port_lanes("fb", np.float32, 1)
    core = rsk.unpack_carry(sc, win)
    sc2, win2 = rsk.pack_carry(core)
    assert torch.equal(sc, sc2) and torch.equal(win, win2)
    assert core[4].dtype == torch.bool and core[12].dtype == torch.bool
    assert core[7].dtype == core[8].dtype == torch.int32
    before = rsk.chunk_step.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rsk.chunk_step(*inputs, sc, win, policy="fb", spec=spec)
    assert rsk.chunk_step.launches == before
    assert spec.resolve_kernel(sc.device) == "torch"
