"""The port's shared policy-step helpers against the JAX package's.

``repro_torch.sim.scan`` writes ``_first_fit``, ``_size_classes``,
``_kill_selection``, ``fb_actions``, ``flb_actions`` and
``stable_compact`` over an explicit leading lane axis. On random windows
(made with numpy from a seed) every output must EQUAL ``jax.vmap`` of the
reference helper, in float32 and float64: every sum they take is a sum of
integer-valued floats, exact in any order.
"""

import numpy as np
import pytest
import torch

import jax

from repro.sim import scan as ref
from repro_torch.sim import scan as port

N, K = 6, 24
DTYPES = [np.float32, np.float64]


def _window(seed, dtype):
    """A batch of random windows: integer sizes (pads are size 0 with
    submit +inf), run / queued / done flags, per-lane scalars."""
    rng = np.random.default_rng(seed)
    size = rng.integers(0, 70, (N, K)).astype(dtype)
    size[:, -3:] = 0.0
    run = rng.random((N, K)) < 0.4
    queued = ~run & (rng.random((N, K)) < 0.5)
    scal = {k: rng.integers(0, 150, N).astype(dtype)
            for k in ("C", "owned", "used", "wsv", "free", "pool", "B",
                      "lb_ws")}
    scal["kill_need"] = rng.integers(0, 90, N).astype(dtype)
    scal["kill_need"][0] = 0.0
    scal["U"] = rng.choice([0.25, 1.5], N).astype(dtype)
    scal["V"] = rng.choice([0.5, 0.9], N).astype(dtype)
    scal["G"] = rng.choice([0.5, 2.0], N).astype(dtype)
    is_tick = rng.random(N) < 0.6
    return size, run, queued, scal, is_tick


def _both(dtype, fn):
    """Run ``fn`` with x64 enabled for float64 (jax defaults to f32)."""
    if dtype == np.float64:
        with jax.enable_x64(True):
            return fn()
    return fn()


def _eq(a, b, label):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=label)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_first_fit_and_size_classes(dtype, seed):
    size, run, queued, s, _ = _window(seed, dtype)

    def go():
        ff = jax.vmap(lambda f, q, z: ref._first_fit(f, q, z, 2))(
            s["free"], queued, size)
        cls = jax.vmap(ref._size_classes)(size)
        return ff, cls

    (free_r, st_r), (cls_r, masks_r) = _both(dtype, go)
    free_p, st_p = port._first_fit(_t(s["free"]), _t(queued), _t(size), 2)
    cls_p, masks_p = port._size_classes(_t(size))
    _eq(free_r, free_p, "free")
    _eq(st_r, st_p, "started")
    _eq(cls_r, cls_p, "cls")
    _eq(masks_r, masks_p, "class masks")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_kill_selection(dtype, seed):
    size, run, _, s, _ = _window(seed, dtype)

    def go():
        cls, masks = jax.vmap(ref._size_classes)(size)
        return jax.vmap(ref._kill_selection)(run, size, cls, masks,
                                             s["kill_need"])

    killed_r = _both(dtype, go)
    cls, masks = port._size_classes(_t(size))
    killed_p = port._kill_selection(_t(run), _t(size), cls, masks,
                                    _t(s["kill_need"]))
    _eq(killed_r, killed_p, "killed")
    assert killed_p.any(), "the window must exercise the kill path"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_fb_actions(dtype, seed):
    size, run, queued, s, is_tick = _window(seed, dtype)

    def go():
        def one(C, owned, r, used, q, wsv, sz, tick):
            cls, masks = ref._size_classes(sz)
            return ref.fb_actions(C, owned, r, used, q, wsv, sz, cls, masks,
                                  tick, 2)
        return jax.vmap(one)(s["C"], s["owned"], run, s["used"], queued,
                             s["wsv"], size, is_tick)

    out_r = _both(dtype, go)
    cls, masks = port._size_classes(_t(size))
    out_p = port.fb_actions(_t(s["C"]), _t(s["owned"]), _t(run),
                            _t(s["used"]), _t(queued), _t(s["wsv"]),
                            _t(size), cls, masks, _t(is_tick), 2)
    for name, a, b in zip(("owned", "run", "starts", "killed", "alloc",
                           "pbj_ev"), out_r, out_p):
        _eq(a, b, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_flb_actions(dtype, seed):
    size, run, queued, s, is_tick = _window(seed, dtype)
    pool = np.minimum(s["pool"], s["owned"])

    def go():
        def one(B, lb, U, V, G, owned, pl, r, used, q, wsv, sz, tick):
            return ref.flb_actions(B, lb, U, V, G, owned, pl, r, used, q,
                                   wsv, sz, tick, 2)
        return jax.vmap(one)(s["B"], s["lb_ws"], s["U"], s["V"], s["G"],
                             s["owned"], pool, run, s["used"], queued,
                             s["wsv"], size, is_tick)

    out_r = _both(dtype, go)
    out_p = port.flb_actions(*(_t(s[k]) for k in ("B", "lb_ws", "U", "V",
                                                  "G", "owned")),
                             _t(pool), _t(run), _t(s["used"]), _t(queued),
                             _t(s["wsv"]), _t(size), _t(is_tick), 2)
    for name, a, b in zip(("owned", "pool_pbj", "run", "starts", "alloc",
                           "pbj_ev"), out_r, out_p):
        _eq(a, b, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_stable_compact(dtype, seed):
    size, run, _, _, _ = _window(seed, dtype)
    rng = np.random.default_rng(100 + seed)
    keep = rng.random((N, K)) < 0.5
    keep[0] = True                     # nothing to drop
    keep[1] = False                    # everything drops
    times = rng.uniform(0, 1e5, (N, K)).astype(dtype)

    def go():
        return jax.vmap(lambda k, r, t, z: ref.stable_compact(
            k, [r, t, z], [False, 0.0, np.inf]))(keep, run, times, size)

    (arrs_r, n_r) = _both(dtype, go)
    arrs_p, n_p = port.stable_compact(_t(keep), [_t(run), _t(times),
                                                 _t(size)],
                                      [False, 0.0, np.inf])
    _eq(n_r, n_p.to(torch.int32), "n_keep")
    for name, a, b in zip(("run", "times", "size"), arrs_r, arrs_p):
        _eq(a, b, name)
