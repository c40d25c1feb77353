"""The generated-scenario WS fold tables (``repro_torch.kernels.ws_fold``).

On the CPU the plain version must equal the JAX package's host build,
``repro.sim.rounds.ws_fold_tables_batch``, element for element wherever
the widths are integers (both policies, leases that do and do not divide
the 300 s step, horizons on and off a lease multiple, one and three
lanes and points, float32 and float64 packs, and the Monte-Carlo cell's
shape), and to a relative 1e-12 in the integral where they are not (its
summation order is free there); a CPU pack folds on the host and
launches nothing. On the card (skipped without one) the kernel must
equal the plain version and the port's host build
(``repro_torch.sim.rounds.ws_fold_tables_batch``, held against the JAX
package's in ``test_torch_rounds.py``) bit for bit at the cell's shape,
and ``pack_scenarios`` must launch it once a call under the default
round-step backend and never under ``kernel="torch"``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ws_fold
from repro_torch.sim import rounds
from repro_torch.sim import scenarios as sc

STEP = 300.0
CELL_W, CELL_N = 256, 4032           # 256 fortnights of 300 s steps
TORCH = {np.float32: torch.float32, np.float64: torch.float64}
LEVELS = {"fb": (4.0, 9.0, 2.0), "flb_nub": (0.0, 3.0, 7.0)}


def _demand(rng, W, N, hi):
    """Integer demand rows with runs of equal values, as the step grid
    has them."""
    steps = rng.integers(-2, 3, (W, N)) * (rng.random((W, N)) < 0.4)
    return np.clip(np.cumsum(steps, 1) + hi // 2, 0, hi).astype(np.float32)


def _jax_fold(*args):
    """The JAX package's host build (imported here: the card's machine
    has no JAX)."""
    from repro.sim.rounds import ws_fold_tables_batch
    return ws_fold_tables_batch(*args)


def _fold(times, values, duration, policy, leases, levels, dtype,
          fold=ws_fold.fold_tables, device="cpu"):
    leases = np.asarray(leases, np.float64)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return fold(on(times), on(values), on(leases),
                on(np.asarray(levels, np.float64)), duration=duration,
                policy=policy, nt=ws_fold.table_width(duration, leases),
                dtype=TORCH[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("exact", [True, False],
                         ids=["horizon_on_lease", "horizon_off_lease"])
@pytest.mark.parametrize("lease", [900.0, 3600.0, 7200.0, 1000.0])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_plain_fold_equals_host(policy, lease, exact, W, P, dtype):
    duration = 24 * lease + (0.0 if exact else 450.0)
    times = np.arange(int(np.ceil(duration / STEP))) * STEP
    rng = np.random.default_rng([W, P, int(lease), int(exact)])
    values = _demand(rng, W, len(times), 14)
    leases = [lease, 2 * lease, lease][:P]
    levels = LEVELS[policy][:P]
    want = _jax_fold(times, values, duration, policy,
                     np.asarray(leases, np.float64),
                     np.asarray(levels, np.float64))
    got = _fold(times, values, duration, policy, leases, levels, dtype)
    for name, a, b in zip(("integral", "winmax", "at_tick"), want, got):
        assert b.dtype == TORCH[dtype], name
        np.testing.assert_array_equal(b.numpy(), a.astype(dtype),
                                      err_msg=name)


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_plain_fold_non_integer_widths(policy):
    """An uneven axis with points past the horizon: the maxima and the
    boundary gathers are exact, the integral to its summation order."""
    rng = np.random.default_rng(7)
    times = np.cumsum(np.r_[0.0, rng.uniform(50.0, 400.0, 199)])
    duration = float(times[-12]) + 0.37
    values = _demand(rng, 3, len(times), 14).astype(np.float64)
    leases, levels = [900.0, 1000.0 / 3.0, 3600.0], LEVELS[policy]
    want = _jax_fold(times, values, duration, policy, np.asarray(leases),
                     np.asarray(levels))
    got = _fold(times, values, duration, policy, leases, levels,
                np.float64)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def _cell_case(policy, lease, seed):
    """The Monte-Carlo cell's fold: 256 lanes x 4032 steps of integer
    demand (peak 128), 16 points (FB: C 128..248 step 8; FLB-NUB: lb_ws
    0..120 step 8), ``lease`` one value or a pair alternating over the
    points."""
    rng = np.random.default_rng(seed)
    times = np.arange(CELL_N) * STEP
    values = np.maximum(_demand(rng, CELL_W, CELL_N, 128), 1.0)
    levels = (np.arange(128.0, 249.0, 8.0) if policy == "fb"
              else np.arange(0.0, 128.0, 8.0))
    pair = np.broadcast_to(np.asarray(lease, np.float64), 2)
    leases = np.resize(pair, len(levels))
    return times, values, CELL_N * STEP, leases, levels


@pytest.mark.parametrize("policy,lease", [
    ("fb", 3600.0), ("flb_nub", (3600.0, 1800.0))])
def test_plain_fold_equals_host_at_the_cells_shape(policy, lease):
    """The cell's shape: FB at one 3600 s lease, and FLB-NUB with mixed
    3600 / 1800 s leases, where NT follows the shorter lease and the
    longer lease's windows past its horizon read 0."""
    times, values, duration, leases, levels = _cell_case(policy, lease, 5)
    want = _jax_fold(times, values, duration, policy, leases, levels)
    got = _fold(times, values, duration, policy, leases, levels,
                np.float64)
    for name, a, b in zip(("integral", "winmax", "at_tick"), want, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _grid(W, days=2.0, max_jobs=200):
    return sc.ScenarioGrid(
        seeds=tuple(range(11, 11 + W)),
        pbj=sc.PBJParams(n_jobs=0.8 * max_jobs),
        ws=sc.WSParams(peak=np.round(np.linspace(16.0, 128.0, W))),
        duration=days * 86400.0, max_jobs=max_jobs)


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_cpu_pack_folds_with_the_plain_version(policy):
    """A CPU pack folds on the host (the round step's plain backend):
    its tables are the JAX package's build, and nothing is launched."""
    synth = sc.synthesize(_grid(3), device="cpu")
    leases, levels = [3600.0, 7200.0], LEVELS[policy][:2]
    before = ws_fold.fold_tables.launches
    pk = sc.pack_scenarios(synth, 64, policy, leases, levels,
                           dtype=np.float64, device="cpu")
    assert ws_fold.fold_tables.launches == before
    want = _jax_fold(synth.ws_times, synth.ws_values, synth.duration,
                     policy, np.asarray(leases), np.asarray(levels))
    for a, b in zip(want, (pk.ws_integral, pk.ws_winmax, pk.ws_at_tick)):
        np.testing.assert_array_equal(b.numpy(), a)


def test_table_width_is_the_hosts_nt():
    assert ws_fold.table_width(1_209_600.0, [3600.0] * 16) == 337
    assert ws_fold.table_width(1_209_600.0, [7200.0, 300.0]) == 4033
    assert ws_fold.table_width(0.0, [3600.0]) == 2
    with pytest.raises(ValueError, match="unknown policy"):
        _fold(np.zeros(1), np.ones((1, 1), np.float32), 300.0, "ec2",
              [300.0], [1.0], np.float32)


# ------------------------------------------------------------- on the card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("policy,lease,dtype", [
    ("fb", 3600.0, np.float64), ("fb", 3600.0, np.float32),
    ("flb_nub", 3600.0, np.float64), ("fb", 300.0, np.float64),
    ("flb_nub", (3600.0, 1800.0), np.float64)])
def test_kernel_equals_plain_at_the_cells_shape(policy, lease, dtype):
    """256 lanes x 4032 steps x 16 points (FB: C 128..248 step 8), one
    launch, bit for bit against the plain version on the same card, and
    again on a second launch; at L 300 s the tables are (256, 16, 4033);
    FLB-NUB with mixed 3600 / 1800 s leases zeroes the longer lease's
    windows past its horizon."""
    dev = _cuda_or_skip()
    times, values, duration, leases, levels = _cell_case(
        policy, lease, int(np.sum(lease)))
    launches = ws_fold.fold_tables.launches
    got = _fold(times, values, duration, policy, leases, levels, dtype,
                device=dev)
    again = _fold(times, values, duration, policy, leases, levels, dtype,
                  device=dev)
    want = _fold(times, values, duration, policy, leases, levels, dtype,
                 fold=ws_fold.fold_tables_ref, device=dev)
    torch.cuda.synchronize()
    assert ws_fold.fold_tables.launches == launches + 2
    nt = ws_fold.table_width(duration, leases)
    assert got[1].shape == (CELL_W, len(levels), nt)
    for name, a, b, c in zip(("integral", "winmax", "at_tick"), got, again,
                             want):
        assert a.dtype == TORCH[dtype], name
        assert torch.equal(a, c), name
        assert torch.equal(a, b), name
    if dtype == np.float64 and np.min(lease) >= 1800.0:
        host = rounds.ws_fold_tables_batch(times, values, duration, policy,
                                           leases, levels)
        for a, h in zip(got, host):
            np.testing.assert_array_equal(a.cpu().numpy(), h)


def test_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    times = torch.arange(8, dtype=torch.float64, device=dev) * STEP
    leases = torch.full((2,), 900.0, dtype=torch.float64, device=dev)
    kw = dict(duration=8 * STEP, policy="fb", nt=4, dtype=torch.float32)
    ok = torch.ones(3, 8, device=dev)
    with pytest.raises(TypeError, match="values"):
        ws_fold.fold_tables(times, ok.int(), leases, leases, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ws_fold.fold_tables(times, torch.ones(8, 3, device=dev).t(), leases,
                            leases, **kw)
    with pytest.raises(TypeError, match="times"):
        ws_fold.fold_tables(times.float(), ok, leases, leases, **kw)
    with pytest.raises(ValueError, match="levels"):
        ws_fold.fold_tables(times, ok, leases, leases[:1], **kw)


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_card_pack_launches_the_fold_once(policy):
    """``pack_scenarios`` on the card: one fold launch a call, its tables
    equal to the CPU pack's (the host's build) bit for bit, every other
    field too; under ``kernel="torch"`` the card's pack folds on the host
    and launches nothing."""
    dev = _cuda_or_skip()
    synth = sc.synthesize(_grid(5), device="cpu")
    leases, levels = [3600.0, 1000.0], LEVELS[policy][:2]
    for dtype in (np.float32, np.float64):
        before = ws_fold.fold_tables.launches
        got = sc.pack_scenarios(synth, 64, policy, leases, levels,
                                dtype=dtype, device=dev)
        assert ws_fold.fold_tables.launches == before + 1
        want = sc.pack_scenarios(synth, 64, policy, leases, levels,
                                 dtype=dtype, device="cpu")
        assert got.device.type == "cuda"
        before = ws_fold.fold_tables.launches
        plain = sc.pack_scenarios(synth, 64, policy, leases, levels,
                                  dtype=dtype, device=dev, kernel="torch")
        assert ws_fold.fold_tables.launches == before
        for f in rounds._PACK_FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
            assert torch.equal(getattr(plain, f).cpu(),
                               getattr(want, f)), f
