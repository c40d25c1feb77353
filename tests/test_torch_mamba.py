"""The port's Mamba2 model and its serving against the JAX package's, on
the CPU.

The JAX ``Model.init(0)`` weights of ``reduced_config(mamba2_130m)`` (2
layers, d 64, 8 SSM heads of 16, state 16, conv 4) go through
``convert.params_from_jax`` into the port's ``Model``. Both prefill the
same numpy-seeded prompts of 24 tokens (one chunk of 24) and 256 tokens
(two chunks of 128) and decode one more token; the logits and all three
cache tensors (``state``, ``conv_x``, ``conv_bc``) are compared after
each. The reference runs ``impl="xla"`` and ``impl="pallas"`` (the SSD
kernel in interpret mode); the port ``impl="torch"`` and ``impl="cuda"``
(on CPU tensors, the kernel's plain version through ``kernels.ops``).
Tolerance: float32 atol 5e-5 / rtol 5e-4, the reference's own between
its paths (``tests/test_models_consistency.py``); bfloat16 weights and
compute atol = rtol = 3e-2, the reference's bfloat16 SSD tolerance
(``tests/test_kernels.py``), a few bfloat16 ulps at these logits of
magnitude up to about 5 (both packages round every projection to
bfloat16, in their own order).

The JAX ``Replica``'s greedy tokens are nearly constant at this size
with random weights, so the serving test compares what each step
computes: the admission logits, every decode step's logits and the slot
caches after every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.models.transformer import Model as RefModel
from repro.serving.engine import Replica as RefReplica
from repro.serving.engine import Request as RefRequest
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Replica, Request

ARCH = "mamba2_130m"
B = 2
TOL = {"float32": (5e-5, 5e-4), "bfloat16": (3e-2, 3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CACHE_KEYS = ("state", "conv_x", "conv_bc")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    """A float32 numpy copy (the port's caches change in place)."""
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    """Weights and compute in one dtype (the reference's scan refuses
    bfloat16 compute over float32 Mamba weights: its carry changes
    type)."""
    ref_cfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    ref_params = RefModel(ref_cfg, make_local_mesh(),
                          compute_dtype=JNP[dtype],
                          param_dtype=JNP[dtype]).init(0)
    model = Model(cfg, "cpu", compute_dtype=TORCH[dtype],
                  param_dtype=TORCH[dtype])
    model.load_state_dict(params_from_jax(_np_tree(ref_params)))
    return dtype, cfg, ref_cfg, ref_params, model


def _ref_run(ref_cfg, params, toks, impl, dtype):
    s = toks.shape[1] - 1
    ref = RefModel(ref_cfg, make_local_mesh(), impl=impl,
                   compute_dtype=JNP[dtype], param_dtype=JNP[dtype])
    cache = ref.init_cache(B, s + 8, dtype=JNP[dtype])
    lg0, cache = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                             cache)
    lg1, cache1 = ref.decode(params, jnp.asarray(toks[:, s:]), cache,
                             jnp.int32(s))
    return lg0, _np_tree(cache), lg1, _np_tree(cache1)


def _port_run(model, toks, impl, dtype):
    s = toks.shape[1] - 1
    m = model.with_impl(impl)
    cache = m.init_cache(B, s + 8, dtype=TORCH[dtype])
    lg0, cache = m.prefill({"tokens": toks[:, :s]}, cache)
    cache0 = {k: {n: t.clone() for n, t in v.items()}
              for k, v in cache.items()}
    lg1, cache = m.decode(toks[:, s:], cache, s)
    return lg0, cache0, lg1, cache


@pytest.mark.parametrize("dtype,prompt", [("float32", 24),
                                          ("float32", 256),
                                          ("bfloat16", 256)])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda")])
def test_prefill_and_decode_match_reference(ref_impl, impl, dtype, prompt):
    _, cfg, ref_cfg, ref_params, model = _setup(dtype)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, prompt + 1),
                                              dtype=np.int32)
    want = _ref_run(ref_cfg, ref_params, toks, ref_impl, dtype)
    got = _port_run(model, toks, impl, dtype)
    atol, rtol = TOL[dtype]
    for i in (0, 2):
        assert got[i].dtype == TORCH[dtype]
        np.testing.assert_allclose(_f32(got[i]), _f32(want[i]), atol=atol,
                                   rtol=rtol)
    for cache_got, cache_want in ((got[1], want[1]), (got[3], want[3])):
        assert cache_got.keys() == cache_want.keys()
        for layer in cache_want:
            assert set(cache_got[layer]) == set(CACHE_KEYS)
            for name in CACHE_KEYS:
                assert cache_got[layer][name].dtype == torch.float32
                np.testing.assert_allclose(_f32(cache_got[layer][name]),
                                           cache_want[layer][name],
                                           atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_names_dtypes_and_values(dtype):
    """Every leaf of the JAX tree lands under its own name, shape and
    dtype: A_log, D, dt_bias and norm_w stay float32 under a bfloat16
    parameter dtype."""
    _, cfg, ref_cfg, ref_params, model = _setup(dtype)
    state = params_from_jax(_np_tree(ref_params))
    assert set(state) == set(model.state_dict())
    mix = {n.split(".")[-1] for n in state if ".mix." in n}
    assert mix == set(mamba2.mamba_shapes(cfg))
    for name, t in model.state_dict().items():
        assert t.shape == state[name].shape, name
        assert t.dtype == state[name].dtype, name
        assert torch.equal(t, state[name]), name
        if name.split(".")[-1] in mamba2.F32_PARAMS:
            assert t.dtype == torch.float32, name


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_decode_matches_full(impl):
    """Prefill S-1 tokens, decode the last one: the logits of the
    full-sequence forward's last position (the port alone, float32, its
    own random weights)."""
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg, "cpu", compute_dtype=torch.float32, impl=impl).init(1)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, 24),
                                             dtype=np.int32)
    cache = m.init_cache(B, 24)
    _, cache = m.prefill({"tokens": toks[:, :23]}, cache)
    lg_a, _ = m.decode(toks[:, 23:], cache, 23)
    lg_b = m(torch.as_tensor(toks))[:, -1:, :]
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=5e-5,
                               rtol=5e-4)


def test_init_and_caches_follow_the_reference_dtypes():
    """The port's own init: A_log = log(linspace(1, 16, heads)) (the
    reference's values), D = 1, dt_bias = norm_w = 0, all float32 under
    bfloat16 weights; Mamba caches are float32 whatever dtype is asked
    for; a prompt shorter than the conv window is refused."""
    cfg = reduced_config(get_config(ARCH))
    ref_cfg = ref_reduced_config(ref_get_config(ARCH))
    ref_a_log = np.asarray(RefModel(ref_cfg, make_local_mesh()).init(0)
                           ["blocks"]["l0"]["mix"]["A_log"])
    m = Model(cfg, "cpu", param_dtype=torch.bfloat16).init(0)
    mix = m.blocks["l0"].mix
    np.testing.assert_allclose(mix["A_log"].numpy(), ref_a_log, rtol=1e-6)
    assert torch.equal(mix["D"], torch.ones_like(mix["D"]))
    assert not mix["dt_bias"].any() and not mix["norm_w"].any()
    for name, t in mix.items():
        want = torch.float32 if name in mamba2.F32_PARAMS else torch.bfloat16
        assert t.dtype == want, name
    cache = m.init_cache(3, 64, dtype=torch.bfloat16)
    d_inner, nh, n = mamba2.dims(cfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache["l0"].items()} \
        == {"state": ((cfg.n_periods, 3, nh, cfg.ssm_head_dim, n),
                      torch.float32),
            "conv_x": ((cfg.n_periods, 3, cfg.ssm_conv - 1, d_inner),
                       torch.float32),
            "conv_bc": ((cfg.n_periods, 3, cfg.ssm_conv - 1, 2 * n),
                        torch.float32)}
    with pytest.raises(ValueError, match="conv window"):
        m.prefill({"tokens": np.zeros((1, 2), np.int32)}, cache)


def _record(calls, fn):
    def wrapped(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        calls.append(_f32(logits))
        return logits, cache
    return wrapped


def _serve(replica, request_cls, schedule, steps, caches):
    pending = [request_cls(rid=i, prompt=p, max_new_tokens=4)
               for i, p in enumerate(schedule)]
    done = []
    for _ in range(steps):
        while pending and replica.admit(pending[0]):
            pending.pop(0)
        done += replica.step()
        caches.append(jax.tree.map(_f32, replica.cache))
        if not pending and not replica.active:
            break
    return {r.rid: [int(t) for t in r.output] for r in done}


def test_replica_steps_equal_reference(monkeypatch):
    """float32 (the Replica default): prompts of 24 and 256 tokens share
    two slots, then a third request of 24 reuses a slot. Admission
    logits, every decode step's logits (all slots) and the slot caches
    after every step equal the JAX Replica's."""
    ref_cfg = ref_reduced_config(ref_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    ref = RefReplica(ref_cfg, make_local_mesh(), slots=2, max_len=300)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref.params)))
    port = Replica(cfg, "cpu", slots=2, max_len=300, params=model)
    assert port.cache_dtype() == torch.float32
    assert ref.cache_dtype() == jnp.float32
    rng = np.random.default_rng(5)
    sched = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
             for s in (24, 256, 24)]
    ref_pre, ref_dec, port_pre, port_dec = [], [], [], []
    ref._prefill = _record(ref_pre, ref._prefill)
    ref._decode = _record(ref_dec, ref._decode)
    monkeypatch.setattr(model, "prefill", _record(port_pre, model.prefill))
    monkeypatch.setattr(model, "decode", _record(port_dec, model.decode))
    ref_caches, port_caches = [], []
    want = _serve(ref, RefRequest, sched, 20, ref_caches)
    got = _serve(port, Request, sched, 20, port_caches)
    assert len(want) == 3 and got == want
    assert len(port_pre) == len(ref_pre) == 3
    assert len(port_dec) == len(ref_dec) == len(port_caches) == 8
    for g, w in zip(port_pre + port_dec, ref_pre + ref_dec):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)
    for g, w in zip(port_caches, ref_caches):
        for layer in w:
            for name in CACHE_KEYS:
                np.testing.assert_allclose(g[layer][name], w[layer][name],
                                           atol=5e-5, rtol=5e-4)


def test_serve_cli_runs_mamba_reduced_on_cpu():
    out = serve.main(["--arch", ARCH, "--requests", "4", "--ticks", "60",
                      "--prompt-len", "16", "--max-new", "3",
                      "--device", "cpu"])
    assert out["completed"] == 4
    assert out["throughput_tokens"] == 4 * 4
    assert out["device"] == "cpu"
