"""The port's cross-attention, encoder and the vlm / audio models against
the JAX package's, on the CPU.

* ``attend_cross``, ``fill_cross_cache``, ``decode_cross_attn`` and
  ``init_cache(cross_len=)`` equal the reference's on numpy-seeded
  weights and inputs, with and without the QKV bias and the softcap, in
  float32, in bfloat16, and in float32 compute over a bfloat16 cache,
  where decode reads K/V rounded to the cache's dtype while prefill's
  output used the fresh float32 projections (the two differ there by
  more than the float32 tolerance, and the port mirrors each);
* ``Model.encode`` (whisper's encoder) equals the reference's;
* reduced whisper_base (2 encoder and 2 decoder layers) and reduced
  llama32_vision_90b (10 layers: 8 self-attention, 2 cross-attention)
  with JAX-initialised weights (``convert.params_from_jax``): prefill
  and decode logits and every cache (``k``, ``v``, ``ck``, ``cv``), at a
  scalar position and at per-row positions, the reference's ``xla``
  path against the port's ``torch`` path and its ``pallas`` path
  (interpret mode) against the port's ``cuda`` path (on CPU tensors,
  the kernels' plain versions), on a seeded standard-normal frontend:
  float32 end to end, bfloat16 layer by layer (each sublayer of the
  port fed the reference's input to it, as ``test_torch_hybrid.py``
  explains; end to end, llama-vision's ten bfloat16 layers put one
  prefill logit 0.036 from the reference's, past the tolerance);
* the frontend matters: logits with a random frontend differ from those
  with zeros, which the serving engine feeds (there every
  cross-attention sublayer adds exactly 0, so a test through the
  ``Replica`` alone could not see a wrong cross-attention);
* decode equals the full forward, a model without a frontend raises;
* a ``Replica`` of each gives the JAX ``Replica``'s greedy tokens and
  per-step logits; ``launch/serve.py`` completes for both.

Tolerances: float32 atol 5e-5 / rtol 5e-4, the reference's own between
its paths (``tests/test_models_consistency.py``); bfloat16 weights and
compute atol = rtol = 3e-2 (``tests/test_torch_mamba.py``). The
bfloat16 runs hold the reference with its ``jax.nn.silu`` computed in
float32 and rounded once, as the port's is: XLA's bfloat16 logistic on
the CPU is one ulp off the rounded sigmoid in about a third of its
elements (``tests/test_torch_moe.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.models import attention as ref_attn
from repro.models.common import AxisSizes
from repro.models.transformer import Model as RefModel
from repro.serving.engine import Replica as RefReplica
from repro.serving.engine import Request as RefRequest
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Replica, Request
from test_torch_hybrid import (JNP, TOL, TORCH, VOCAB, _close, _f32,
                               _np_tree, _silu_rounded_once,
                               assert_layers_match_reference, model_pair)

ARCHS = ["whisper_base", "llama32_vision_90b"]
B, PROMPT = 2, 24


def _frontend(cfg, batch=B, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------- functions

def _cross_inputs(cfg, dtype):
    rng = np.random.default_rng(7)
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    shapes = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd),
              "wo": (h, hd, d), "bq": (h, hd), "bk": (k, hd), "bv": (k, hd)}
    p = {n: (rng.standard_normal(s) * (0.3 if n[0] == "b" else d ** -0.5))
         .astype(np.float32) for n, s in shapes.items()}
    if not cfg.qkv_bias:
        p = {n: v for n, v in p.items() if n[0] != "b"}
    x = rng.standard_normal((B, 5, d)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
    src = rng.standard_normal((B, cfg.frontend_len, d)).astype(np.float32)
    jp = {n: jnp.asarray(v, JNP[dtype]) for n, v in p.items()}
    tp = {n: torch.from_numpy(v).to(TORCH[dtype]) for n, v in p.items()}
    return (jp, *(jnp.asarray(a, JNP[dtype]) for a in (x, x1, src)),
            tp, *(torch.from_numpy(a).to(TORCH[dtype]) for a in (x, x1, src)))


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("compute,cache_dtype", [("float32", "float32"),
                                                 ("float32", "bfloat16"),
                                                 ("bfloat16", "bfloat16")])
def test_cross_attention_functions_match_reference(compute, cache_dtype,
                                                   qkv_bias, softcap):
    over = dict(vocab=VOCAB, qkv_bias=qkv_bias, attn_softcap=softcap)
    cfg = reduced_config(get_config("whisper_base"), **over)
    ref_cfg = ref_reduced_config(ref_get_config("whisper_base"), **over)
    ax = AxisSizes.single()
    jp, jx, jx1, jsrc, tp, tx, tx1, tsrc = _cross_inputs(cfg, compute)
    tol = "bfloat16" if "bfloat16" in (compute, cache_dtype) else "float32"

    want_cache = ref_attn.init_cache(ref_cfg, B, 9, cross_len=cfg.frontend_len,
                                     dtype=JNP[cache_dtype])
    cache = attn.init_cache(cfg, B, 9, cross_len=cfg.frontend_len,
                            dtype=TORCH[cache_dtype])
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in cache.items()} \
        == {n: (a.shape, str(a.dtype)) for n, a in want_cache.items()}
    assert set(attn.init_cache(cfg, B, 9)) == {"k", "v"}

    want = ref_attn.attend_cross(jp, jx, jsrc, ref_cfg, ax)
    got = attn.attend_cross(tp, tx, tsrc, cfg)
    assert got.dtype == TORCH[compute]
    _close(got, want, compute)

    want_cache = ref_attn.fill_cross_cache(jp, jsrc, ref_cfg, want_cache)
    assert attn.fill_cross_cache(tp, tsrc, cfg, cache) is cache
    for name in ("ck", "cv"):
        assert cache[name].dtype == TORCH[cache_dtype]
        _close(cache[name], want_cache[name], tol, name)
    assert not cache["k"].any() and not cache["v"].any()

    want1 = ref_attn.decode_cross_attn(jp, jx1, ref_cfg, ax, want_cache)
    got1 = attn.decode_cross_attn(tp, tx1, cfg, cache)
    assert got1.dtype == TORCH[compute]
    _close(got1, want1, tol)
    if compute != cache_dtype:
        # Decode reads the rounded cache, prefill the fresh projections.
        fresh = attn.attend_cross(tp, tx1, tsrc, cfg)
        assert np.abs(_f32(fresh) - _f32(got1)).max() > 10 * TOL[compute][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype, monkeypatch):
    monkeypatch.setattr(jax.nn, "silu", _silu_rounded_once)
    ref_cfg = ref_reduced_config(ref_get_config("whisper_base"), vocab=VOCAB)
    cfg = reduced_config(get_config("whisper_base"), vocab=VOCAB)
    ref = RefModel(ref_cfg, make_local_mesh(), compute_dtype=JNP[dtype],
                   param_dtype=JNP[dtype])
    params = ref.init(0)
    model = Model(cfg, "cpu", compute_dtype=TORCH[dtype],
                  param_dtype=TORCH[dtype])
    model.load_state_dict(params_from_jax(_np_tree(params)))
    frames = _frontend(cfg)
    want = ref.encode(params, jnp.asarray(frames))
    got = model.encode(frames)
    assert got.dtype == TORCH[dtype] and got.shape == frames.shape
    _close(got, want, dtype)


# ----------------------------------------------------------- whole models

@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, ref_impl, impl):
    """float32: one prefill, then one decode step at a scalar position
    and one at per-row positions, each from the prefill's cache."""
    dtype = "float32"
    cfg, ref_cfg, params, model = model_pair(arch, dtype)
    toks = np.random.default_rng(11).integers(0, VOCAB, (B, PROMPT + 1),
                                              dtype=np.int32)
    frontend = _frontend(cfg)
    ref = RefModel(ref_cfg, make_local_mesh(), impl=ref_impl,
                   compute_dtype=JNP[dtype], param_dtype=JNP[dtype])
    cache = ref.init_cache(B, PROMPT + 8, dtype=JNP[dtype])
    want0, cache = ref.prefill(params, {
        "tokens": jnp.asarray(toks[:, :PROMPT]),
        "frontend": jnp.asarray(frontend)}, cache)
    m = model.with_impl(impl)
    got_cache = m.init_cache(B, PROMPT + 8, dtype=TORCH[dtype])
    got0, got_cache = m.prefill({"tokens": toks[:, :PROMPT],
                                 "frontend": frontend}, got_cache)
    _close(got0, want0, dtype)
    runs = [(got0, got_cache, want0, cache)]
    for pos in (PROMPT, np.full(B, PROMPT)):
        want1, want_c = ref.decode(params, jnp.asarray(toks[:, PROMPT:]),
                                   cache, jnp.asarray(pos, jnp.int32))
        c = {k: {n: t.clone() for n, t in v.items()}
             for k, v in got_cache.items()}
        got1, c = m.decode(toks[:, PROMPT:], c, torch.as_tensor(pos))
        _close(got1, want1, dtype, f"pos {pos}")
        runs.append((got1, c, want1, want_c))
    for _, got_c, _, want_c in runs:
        assert got_c.keys() == want_c.keys()
        for layer, tensors in want_c.items():
            assert set(got_c[layer]) == set(tensors), layer
            for name, want in tensors.items():
                assert got_c[layer][name].dtype == TORCH[dtype]
                _close(got_c[layer][name], want, dtype, f"{layer}.{name}")


@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda")])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_reference(arch, ref_impl, impl, monkeypatch):
    """bfloat16 weights and compute, held layer by layer (as
    ``test_torch_hybrid.py`` holds the hybrid): the frontend's output,
    every sublayer fed the reference's input to it, every cache and the
    logits, at a scalar position and at per-row positions."""
    assert_layers_match_reference(arch, "bfloat16", ref_impl, impl, PROMPT,
                                  _frontend(model_pair(arch, "bfloat16")[0]),
                                  monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_changes_logits_and_is_required(arch):
    """A random frontend against the serving engine's zeros. With zeros
    the cross K/V are 0, so every cross-attention sublayer adds exactly
    0: the logits equal, bit for bit, those of a copy whose
    cross-attention output projections are zero (in which the frontend
    changes nothing). A random frontend moves them. No frontend:
    ValueError."""
    cfg, _, _, model = model_pair(arch, "float32")
    muted = copy.deepcopy(model)
    for i, sp in enumerate(muted.pattern):
        layer = muted.blocks[f"l{i}"]
        if sp.cross:
            layer.cross["wo"].zero_()
        if sp.mixer == "attn_cross":
            layer.mix["wo"].zero_()
    toks = np.random.default_rng(2).integers(0, VOCAB, (B, PROMPT),
                                             dtype=np.int32)
    zeros = np.zeros((B, cfg.frontend_len, cfg.d_model), np.float32)
    logits = {}
    for name, front in (("random", _frontend(cfg)), ("zeros", zeros)):
        for m in (model, muted):
            cache = m.init_cache(B, PROMPT, dtype=torch.float32)
            logits[name, m is muted], cache = m.prefill(
                {"tokens": toks, "frontend": front}, cache)
            ck = [c["ck"] for c in cache.values() if "ck" in c]
            assert ck and all(bool(t.any()) == (name == "random")
                              for t in ck)
    assert torch.equal(logits["zeros", False], logits["zeros", True])
    assert torch.equal(logits["random", True], logits["zeros", True])
    assert (logits["random", False] - logits["zeros", False]).abs().max() \
        > 0.1
    with pytest.raises(ValueError, match="frontend"):
        model.prefill({"tokens": toks}, model.init_cache(B, PROMPT))
    with pytest.raises(ValueError, match="frontend"):
        model(toks)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full(arch, impl):
    """Prefill S-1 tokens, decode the last one: the full forward's last
    position (the port alone, float32, random frontend)."""
    cfg, _, _, model = model_pair(arch, "float32")
    m = model.with_impl(impl)
    toks = np.random.default_rng(3).integers(0, VOCAB, (B, PROMPT),
                                             dtype=np.int32)
    front = _frontend(cfg)
    cache = m.init_cache(B, PROMPT, dtype=torch.float32)
    _, cache = m.prefill({"tokens": toks[:, :-1], "frontend": front}, cache)
    lg_a, _ = m.decode(toks[:, -1:], cache, PROMPT - 1)
    lg_b = m(toks, front)[:, -1:, :]
    _close(lg_a, lg_b, "float32")


def test_caches_and_parameters_follow_the_layer_kinds():
    """whisper's decoder layers hold k / v and ck / cv, llama-vision's
    cross-attention layers ck / cv only, of frontend_len; the encoder,
    norm_cross and front_norm parameters sit under the reference's
    names."""
    for arch in ARCHS:
        cfg, _, params, model = model_pair(arch, "float32")
        cache = model.init_cache(3, 40, dtype=torch.bfloat16)
        kv, hd, n = cfg.n_kv_heads, cfg.head_dim_, cfg.n_periods
        for i, sp in enumerate(model.pattern):
            want = {}
            if sp.mixer != "attn_cross":
                want.update(k=(n, 3, kv, 40, hd), v=(n, 3, kv, 40, hd))
            if sp.cross or sp.mixer == "attn_cross":
                want.update(ck=(n, 3, kv, cfg.frontend_len, hd),
                            cv=(n, 3, kv, cfg.frontend_len, hd))
            assert {k: tuple(t.shape) for k, t in cache[f"l{i}"].items()} \
                == want
        names = set(model.state_dict())
        if arch == "whisper_base":
            assert {"encoder.blocks.mix.wq", "encoder.norm",
                    "blocks.l0.norm_cross", "blocks.l0.cross.wq"} <= names
            assert model.encoder.blocks.mix["wq"].shape[0] == 2
        else:
            assert {"front_norm", "blocks.l4.mix.wq"} <= names
            assert not any("cross" in k or "encoder" in k for k in names)


# ------------------------------------------------------------------ serving

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


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_tokens_equal_reference(arch, monkeypatch):
    """float32 (the Replica default), the reference's zeros frontend:
    the greedy tokens, the admission logits and every decode step's
    logits equal the JAX Replica's."""
    ref_cfg = ref_reduced_config(ref_get_config(arch), vocab=VOCAB)
    cfg = reduced_config(get_config(arch), vocab=VOCAB)
    ref = RefReplica(ref_cfg, make_local_mesh(), slots=3, max_len=48)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref.params)))
    port = Replica(cfg, "cpu", slots=3, max_len=48, params=model)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (3, 30, 12, 9)]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch):
    out = serve.main(["--arch", arch, "--requests", "4", "--ticks", "60",
                      "--prompt-len", "8", "--max-new", "3",
                      "--device", "cpu"])
    assert out["completed"] == 4 and out["throughput_tokens"] == 4 * 4
