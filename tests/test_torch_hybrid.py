"""The port's hybrid attention / Mamba2 / MoE model (jamba) against the
JAX package's, on the CPU.

Reduced jamba15_large_398b: one period of 8 layers (attention at index
3, Mamba2 elsewhere; MoE MLPs of 4 experts, top-2, at odd indices,
dense MLPs at even ones), d 64, 8 SSM heads of 16, state 16, vocab 256.
The JAX ``Model.init(0)`` weights go through ``convert.params_from_jax``
into the port's ``Model``.

* float32: prefill of 24 tokens (inside one chunk) and of 256 (two
  chunks of 128, what the reference's Pallas SSD requires past one
  chunk), then one decode step at a scalar position and one at per-row
  positions: logits and every cache (``k``, ``v``, ``state``,
  ``conv_x``, ``conv_bc``) against the reference's, its ``xla`` path
  against the port's ``torch`` path and its ``pallas`` path (interpret
  mode) against the port's ``cuda`` path (on CPU tensors, the kernels'
  plain versions); atol 5e-5 / rtol 5e-4, the reference's own between
  its paths (``tests/test_models_consistency.py``).
* bfloat16 (weights and compute): the same runs held layer by layer
  (``assert_layers_match_reference``, also used by
  ``test_torch_cross.py``): every sublayer of the port (mixer, cross
  sublayer, MLP) takes the reference's own input to it, and its output,
  the caches it writes and the final logits are held at atol = rtol =
  3e-2 (``tests/test_torch_mamba.py``). End to end, two bfloat16
  implementations of this random-weight stack drift apart further than
  that: with the inputs shared, each sublayer of the port is within two
  bfloat16 ulps of the reference's in under 0.2 % of its elements, and
  chained through 8 layers (the SSD scan spreads a difference along the
  sequence, and a moved value can flip a near-tied MoE router choice)
  the logits end 0.06 apart at 256 tokens, while the reference's own
  bfloat16 logits lie 0.44 from its float32 ones. The reference's
  ``jax.nn.silu`` is computed in float32 and rounded once there, as the
  port's is (XLA's bfloat16 logistic on the CPU is one ulp off the
  rounded sigmoid in about a third of its elements,
  ``tests/test_torch_moe.py``).
* decode equals the full forward (the port alone), with the MoE capacity
  raised so that no pair is dropped, as the reference's
  ``test_decode_matches_full_moe`` does;
* a ``Replica`` gives the JAX ``Replica``'s greedy tokens and per-step
  logits, and ``launch/serve.py`` completes.
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
from repro.models import attention as ref_attn
from repro.models import mlp as ref_mlp
from repro.models.common import AxisSizes
from repro.models.common import rms_norm as ref_rms_norm
from repro.models.transformer import Model as RefModel
from repro.serving.engine import Replica as RefReplica
from repro.serving.engine import Request as RefRequest
from repro_torch.configs.base import MOE, NONE, get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models import mlp as F
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Replica, Request

ARCH = "jamba15_large_398b"
B, VOCAB = 2, 256
TOL = {"float32": (5e-5, 5e-4), "bfloat16": (3e-2, 3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CACHE_KEYS = {"attn": {"k", "v"}, "mamba": {"state", "conv_x", "conv_bc"}}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    """A float32 numpy copy (the port's caches change in place)."""
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(a):
    """A JAX array as a torch tensor of the same dtype."""
    return params_from_jax({"a": np.asarray(a)})["a"]


def _close(got, want, dtype, msg=""):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def _silu_rounded_once(x):
    return (x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))
            ).astype(x.dtype)


def _assert_caches(got, want, dtype):
    assert got.keys() == want.keys()
    for layer, tensors in want.items():
        assert set(got[layer]) == set(tensors), layer
        for name, w in tensors.items():
            assert got[layer][name].dtype == _torch(w[:0]).dtype, name
            _close(got[layer][name], w, dtype, f"{layer}.{name}")


@functools.lru_cache(maxsize=None)
def model_pair(arch, dtype):
    """(cfg, reference cfg, JAX params, the port's Model with them) for
    ``reduced_config(arch, vocab=256)``, weights and compute in
    ``dtype``."""
    ref_cfg = ref_reduced_config(ref_get_config(arch), vocab=VOCAB)
    cfg = reduced_config(get_config(arch), vocab=VOCAB)
    params = RefModel(ref_cfg, make_local_mesh(), compute_dtype=JNP[dtype],
                      param_dtype=JNP[dtype]).init(0)
    model = Model(cfg, "cpu", compute_dtype=TORCH[dtype],
                  param_dtype=TORCH[dtype])
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return cfg, ref_cfg, params, model


@functools.lru_cache(maxsize=None)
def _ref_sublayers(arch, dtype, ref_impl):
    """The reference ``Model`` and its sublayers, jitted (run eagerly,
    a JAX op at a time, they take minutes here)."""
    ref_cfg = model_pair(arch, dtype)[1]
    ref = RefModel(ref_cfg, make_local_mesh(), impl=ref_impl,
                   compute_dtype=JNP[dtype], param_dtype=JNP[dtype])
    ax = AxisSizes.single()

    def cross(p, h, cache, src, mode):
        if mode == "decode":
            return ref_attn.decode_cross_attn(p, h, ref_cfg, ax, cache), cache
        return (ref_attn.attend_cross(p, h, src, ref_cfg, ax),
                ref_attn.fill_cross_cache(p, src, ref_cfg, cache))

    return ref, {
        "mixer": jax.jit(lambda lp, h, c, pos, src, sp, mode: ref._mixer(
            lp, sp, h, mode, c, pos, src), static_argnums=(5, 6)),
        "cross": jax.jit(cross, static_argnums=(4,)),
        MOE: jax.jit(lambda p, h: ref_mlp.moe_mlp(p, h, ref_cfg, ax,
                                                   ref.mesh)),
        "dense": jax.jit(lambda p, h: ref_mlp.dense_mlp(p, h, ax)),
        "norm": jax.jit(ref_rms_norm),
    }


def _layers(fns, ref, params, model, x, cache, port_cache, mode, pos, src,
            dtype):
    """One pass of ``mode`` over every layer of every period, each
    sublayer of the port fed the reference's input to it; returns the
    reference's residual stream and cache. ``port_cache`` is written in
    place."""
    norm = fns["norm"]
    port_params = model.params()
    src_t = None if src is None else _torch(src)
    pos_t = None if pos is None else torch.as_tensor(np.array(pos))
    periods = []
    for i in range(ref.cfg.n_periods):
        new = {}
        for li, sp in enumerate(ref.pattern):
            name = f"l{li}"
            lp = jax.tree.map(lambda a: a[i], params["blocks"][name])
            lpt = {k: (v[i] if isinstance(v, torch.Tensor)
                       else {n: t[i] for n, t in v.items()})
                   for k, v in port_params["blocks"][name].items()}
            lc = {k: v[i] for k, v in cache[name].items()}
            lct = {k: v[i] for k, v in port_cache[name].items()}
            mix_c, mix_ct = lc, lct
            if sp.cross:
                mix_c = {k: lc[k] for k in ("k", "v")}
                mix_ct = {k: lct[k] for k in ("k", "v")}
            h = norm(x, lp["norm1"])
            out, mix_c = fns["mixer"](lp, h, mix_c, pos, src, sp, mode)
            got, _ = model._mixer(lpt, sp, _torch(h), mode, mix_ct, pos_t,
                                  src_t)
            _close(got, out, dtype, f"period {i} {name} mixer ({mode})")
            x = x + out
            nc = dict(mix_c)
            if sp.cross:
                hc = norm(x, lp["norm_cross"])
                out, cross_c = fns["cross"](
                    lp["cross"], hc, {k: lc[k] for k in ("ck", "cv")}, src,
                    mode)
                got = model._cross(lpt["cross"], _torch(hc), mode,
                                   {k: lct[k] for k in ("ck", "cv")}, src_t)
                _close(got, out, dtype, f"period {i} {name} cross ({mode})")
                x = x + out
                nc.update(cross_c)
            if sp.mlp != NONE:
                h2 = norm(x, lp["norm2"])
                out = fns[sp.mlp](lp["mlp"], h2)
                got = F.moe_mlp(lpt["mlp"], _torch(h2), model.cfg) \
                    if sp.mlp == MOE else F.dense_mlp(lpt["mlp"], _torch(h2))
                _close(got, out, dtype, f"period {i} {name} mlp ({mode})")
                x = x + out
            new[name] = nc
        periods.append(new)
    return x, jax.tree.map(lambda *a: jnp.stack(a), *periods)


def assert_layers_match_reference(arch, dtype, ref_impl, impl, prompt,
                                  frontend=None, monkeypatch=None):
    """Prefill ``prompt`` tokens, then decode one at a scalar position
    and one at per-row positions (each from the reference's prefill
    cache), the port fed the reference's input to each sublayer: its
    outputs, every cache it writes and the logits from the reference's
    last hidden state within ``TOL[dtype]``. The reference's silu is
    rounded once (``monkeypatch``)."""
    monkeypatch.setattr(jax.nn, "silu", _silu_rounded_once)
    cfg, ref_cfg, params, model = model_pair(arch, dtype)
    m = model.with_impl(impl)
    ref, fns = _ref_sublayers(arch, dtype, ref_impl)
    toks = np.random.default_rng(11).integers(0, VOCAB, (B, prompt + 1),
                                              dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :prompt])}
    if frontend is not None:
        batch["frontend"] = jnp.asarray(frontend)
    src = ref._frontend(params, batch)
    port_params = m.params()
    port_src = m._frontend(port_params, {"frontend": frontend})
    if src is not None:
        _close(port_src, src, dtype, "frontend")
    x = ref._embed(params, batch["tokens"])
    _close(m._embed(port_params, torch.as_tensor(toks[:, :prompt]).long()),
           x, dtype, "embed")
    cache = ref.init_cache(B, prompt + 8, dtype=JNP[dtype])
    port_cache = m.init_cache(B, prompt + 8, dtype=TORCH[dtype])
    x, cache = _layers(fns, ref, params, m, x, cache, port_cache,
                       "prefill", None, src, dtype)
    _assert_caches(port_cache, cache, dtype)
    _close(m._logits(port_params, _torch(x[:, -1:])),
           ref._logits(params, x[:, -1:]), dtype, "prefill logits")
    for pos in (jnp.int32(prompt), jnp.full((B,), prompt, jnp.int32)):
        x1 = ref._embed(params, jnp.asarray(toks[:, prompt:]))
        port_cache = jax.tree.map(_torch, cache)
        x1, cache1 = _layers(fns, ref, params, m, x1, cache, port_cache,
                             "decode", pos, None, dtype)
        _assert_caches(port_cache, cache1, dtype)
        _close(m._logits(port_params, _torch(x1)), ref._logits(params, x1),
               dtype, f"decode logits, pos {pos}")


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("prompt", [24, 256])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda")])
def test_prefill_and_decode_match_reference(ref_impl, impl, prompt):
    cfg, ref_cfg, params, model = model_pair(ARCH, "float32")
    toks = np.random.default_rng(11).integers(0, VOCAB, (B, prompt + 1),
                                              dtype=np.int32)
    ref = RefModel(ref_cfg, make_local_mesh(), impl=ref_impl,
                   compute_dtype=jnp.float32)
    cache = ref.init_cache(B, prompt + 8, dtype=jnp.float32)
    want0, cache = ref.prefill(params,
                               {"tokens": jnp.asarray(toks[:, :prompt])},
                               cache)
    m = model.with_impl(impl)
    got_cache = m.init_cache(B, prompt + 8, dtype=torch.float32)
    got0, got_cache = m.prefill({"tokens": toks[:, :prompt]}, got_cache)
    _close(got0, want0, "float32", "prefill logits")
    _assert_caches(got_cache, _np_tree(cache), "float32")
    for li, sp in enumerate(model.pattern):
        assert set(got_cache[f"l{li}"]) == CACHE_KEYS[sp.mixer]
    for pos in (prompt, np.full(B, prompt)):
        want1, want_c = ref.decode(params, jnp.asarray(toks[:, prompt:]),
                                   cache, jnp.asarray(pos, jnp.int32))
        c = {k: {n: t.clone() for n, t in v.items()}
             for k, v in got_cache.items()}
        got1, c = m.decode(toks[:, prompt:], c, torch.as_tensor(pos))
        _close(got1, want1, "float32", f"decode logits, pos {pos}")
        _assert_caches(c, _np_tree(want_c), "float32")


@pytest.mark.parametrize("prompt", [24, 256])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda")])
def test_bf16_layers_match_reference(ref_impl, impl, prompt, monkeypatch):
    assert_layers_match_reference(ARCH, "bfloat16", ref_impl, impl, prompt,
                                  monkeypatch=monkeypatch)


def test_pattern_parameters_and_dtypes():
    """One period of 8 layers: attention at 3, Mamba2 elsewhere, MoE at
    odd indices; every JAX leaf lands under its own name, shape and
    dtype (the router, A_log, D, dt_bias and norm_w float32 under
    bfloat16 weights)."""
    cfg, _, params, model = model_pair(ARCH, "bfloat16")
    assert [(sp.mixer, sp.mlp) for sp in model.pattern] == [
        ("attn" if i == 3 else "mamba", "moe" if i % 2 else "dense")
        for i in range(8)]
    assert cfg.n_periods == 1 and cfg.n_experts == 4
    state = params_from_jax(_np_tree(params))
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert t.dtype == state[name].dtype and torch.equal(t, state[name])
        f32 = name.split(".")[-1] in mamba2.F32_PARAMS + ("router",) \
            or "norm" in name
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_decode_matches_full(impl, monkeypatch):
    monkeypatch.setattr(F, "CAPACITY_FACTOR", 64.0)
    cfg, _, _, model = model_pair(ARCH, "float32")
    m = model.with_impl(impl)
    toks = np.random.default_rng(3).integers(0, VOCAB, (B, 24),
                                             dtype=np.int32)
    cache = m.init_cache(B, 24, dtype=torch.float32)
    _, cache = m.prefill({"tokens": toks[:, :23]}, cache)
    lg_a, _ = m.decode(toks[:, 23:], cache, 23)
    lg_b = m(toks)[:, -1:, :]
    _close(lg_a, lg_b, "float32")


def _record(calls, fn):
    def wrapped(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        calls.append(_f32(logits))
        return logits, cache
    return wrapped


def _serve(replica, request_cls, prompts, steps=40):
    pending = [request_cls(rid=i, prompt=p, max_new_tokens=5)
               for i, p in enumerate(prompts)]
    done = []
    for _ in range(steps):
        while pending and replica.admit(pending[0]):
            pending.pop(0)
        done += replica.step()
        if not pending and not replica.active:
            break
    return {r.rid: [int(t) for t in r.output] for r in done}


def test_replica_tokens_equal_reference(monkeypatch):
    """float32: prompts of 3-30 tokens and one of 128 through 3 slots;
    the greedy tokens, the admission logits and every decode step's
    logits equal the JAX Replica's."""
    ref_cfg = ref_reduced_config(ref_get_config(ARCH), vocab=VOCAB)
    cfg = reduced_config(get_config(ARCH), vocab=VOCAB)
    ref = RefReplica(ref_cfg, make_local_mesh(), slots=3, max_len=140)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref.params)))
    port = Replica(cfg, "cpu", slots=3, max_len=140, params=model)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (3, 30, 128, 9)]
    ref_calls, port_calls = [], []
    ref._prefill = _record(ref_calls, ref._prefill)
    ref._decode = _record(ref_calls, ref._decode)
    monkeypatch.setattr(model, "prefill", _record(port_calls, model.prefill))
    monkeypatch.setattr(model, "decode", _record(port_calls, model.decode))
    want = _serve(ref, RefRequest, prompts)
    got = _serve(port, Request, prompts)
    assert len(want) == 4 and got == want
    assert len(port_calls) == len(ref_calls)
    for g, w in zip(port_calls, ref_calls):
        _close(g, w, "float32")


def test_serve_cli_runs_on_cpu():
    out = serve.main(["--arch", ARCH, "--requests", "4", "--ticks", "60",
                      "--prompt-len", "16", "--max-new", "3",
                      "--device", "cpu"])
    assert out["completed"] == 4 and out["throughput_tokens"] == 4 * 4
