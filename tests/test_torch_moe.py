"""The port's Mixture-of-Experts layer and MoE models against the JAX
package's, on the CPU.

* ``moe_mlp`` equals the reference's ``_moe_local`` (the one-device body
  of its ``shard_map``, ``model_sharded=False``) on the same numpy
  inputs, at a prefill-sized and a decode-sized token count: float32
  within atol 1e-6 + rtol 1e-5 (both sum the same products in another
  order). bfloat16: bit for bit against the reference with its
  ``jax.nn.silu`` computed in float32 and rounded once, as the port's
  is; against the reference as it stands within two bfloat16 ulps at the
  output's scale (2^-6 · max |want|), since XLA's bfloat16 logistic on
  the CPU is one ulp off the correctly rounded sigmoid in about a third
  of its elements (measured on 200 k normal inputs);
* a router that sends every token to one expert drops (token, choice)
  pairs past the capacity, in both;
* ``_capacity`` equals the reference's for every token count in 1-4096;
* reduced granite_moe_3b and grok1_314b (4 experts, top-2) construct,
  and their prefill and decode logits and KV caches equal the reference
  ``Model``'s with JAX-initialised weights (``convert.params_from_jax``)
  at ``test_torch_models.py``'s atol 5e-5 / rtol 5e-4, on random
  prompts and on a one-token prompt whose identical hidden states send
  every token to the same experts, so pairs are dropped;
* the serving path is unchanged: a ``Replica`` of reduced granite_moe_3b
  gives the JAX ``Replica``'s greedy tokens, and ``launch/serve.py
  --arch granite_moe_3b`` completes its requests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.models import mlp as ref_mlp
from repro.models.transformer import Model as RefModel
from repro.serving.engine import Replica as RefReplica
from repro.serving.engine import Request as RefRequest
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import mlp as F
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Replica, Request

ATOL, RTOL = 5e-5, 5e-4
F32_TOL = (1e-6, 1e-5)
BF16_SCALE_TOL = 2 ** -6
ARCHS = ["granite_moe_3b", "grok1_314b"]
B = 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _layer_inputs(cfg, n, seed, overload=False):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    x = rng.standard_normal((n, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    if overload:
        # every token prefers expert 0: a shared offset along its column
        x += 2.0
        router[:, 0] += 1.0
    w1, w3 = ((rng.standard_normal((e, d, f)) * d ** -0.5)
              .astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return x, router, w1, w3, w2


def _silu_rounded_once(x):
    return (x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))
            ).astype(x.dtype)


def _run_both(cfg, ref_cfg, inputs, bf16):
    x, router, w1, w3, w2 = inputs
    if bf16:
        jx, j1, j3, j2 = (jnp.asarray(a, jnp.bfloat16)
                          for a in (x, w1, w3, w2))
    else:
        jx, j1, j3, j2 = (jnp.asarray(a) for a in (x, w1, w3, w2))
    want = ref_mlp._moe_local(jx, jnp.asarray(router), j1, j3, j2, ref_cfg,
                              model_sharded=False)
    dt = torch.bfloat16 if bf16 else torch.float32
    p = {"router": torch.from_numpy(router),
         **{k: torch.from_numpy(a).to(dt)
            for k, a in (("w1", w1), ("w3", w3), ("w2", w2))}}
    got = F.moe_mlp(p, torch.from_numpy(x).to(dt)[None], cfg)[0]
    assert got.dtype == dt
    return got.float().numpy(), np.asarray(want.astype(jnp.float32)), p


def _assert_layer(cfg, ref_cfg, inputs, dtype, monkeypatch):
    if dtype == np.float32:
        got, want, p = _run_both(cfg, ref_cfg, inputs, False)
        np.testing.assert_allclose(got, want, atol=F32_TOL[0],
                                   rtol=F32_TOL[1])
        return p
    got, want, p = _run_both(cfg, ref_cfg, inputs, True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_SCALE_TOL * np.abs(want).max())
    with monkeypatch.context() as m:
        m.setattr(jax.nn, "silu", _silu_rounded_once)
        got, want, p = _run_both(cfg, ref_cfg, inputs, True)
    np.testing.assert_array_equal(got, want)
    return p


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("n", [96, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_equals_reference(arch, n, dtype, monkeypatch):
    cfg = reduced_config(get_config(arch))
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    _assert_layer(cfg, ref_cfg, _layer_inputs(cfg, n, 5 + n), dtype,
                  monkeypatch)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_moe_layer_drops_pairs_past_capacity(dtype, monkeypatch):
    cfg = reduced_config(get_config("granite_moe_3b"))
    ref_cfg = ref_reduced_config(ref_get_config("granite_moe_3b"))
    inputs = _layer_inputs(cfg, 96, 3, overload=True)
    p = _assert_layer(cfg, ref_cfg, inputs, dtype, monkeypatch)
    _, ik, _, keep = F._route(torch.from_numpy(inputs[0]), p["router"], cfg)
    assert int((~keep).sum()) > 0
    assert int((ik[:, 0] == 0).sum()) == 96


def test_capacity_equals_reference():
    for arch in ARCHS + ["jamba15_large_398b"]:
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        assert [F._capacity(n, cfg) for n in range(1, 4097)] == \
            [ref_mlp._capacity(n, ref_cfg) for n in range(1, 4097)]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_families_construct(arch):
    """MoE models construct (they raised before the MoE layer was
    ported); the router is float32 whatever the parameter dtype."""
    cfg = reduced_config(get_config(arch))
    model = Model(cfg, "cpu", param_dtype=torch.bfloat16).init(0)
    mlp = model.blocks["l0"].mlp
    assert mlp["router"].dtype == torch.float32
    assert mlp["w1"].dtype == torch.bfloat16
    assert tuple(mlp["w2"].shape) == (cfg.n_periods, cfg.n_experts,
                                      cfg.d_ff, cfg.d_model)


# ------------------------------------------------------------ whole models

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    ref = RefModel(ref_cfg, make_local_mesh(), compute_dtype=jnp.float32)
    ref_params = ref.init(0)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref_params)))
    return cfg, ref, ref_params, model


def _prompt(cfg, kind, s=40):
    if kind == "random":
        return np.random.default_rng(11).integers(0, cfg.vocab, (B, s + 1),
                                                  dtype=np.int32)
    return np.full((B, s + 1), 7, np.int32)


@pytest.mark.parametrize("kind", ["random", "one_token"])
def test_moe_model_equals_reference(setup, kind, monkeypatch):
    cfg, ref, ref_params, model = setup
    toks = _prompt(cfg, kind)
    s = toks.shape[1] - 1
    cache = ref.init_cache(B, s + 8, dtype=jnp.float32)
    lg0, cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks[:, :s])},
                             cache)
    cache0 = _np_tree(cache)
    lg1, cache1 = ref.decode(ref_params, jnp.asarray(toks[:, s:]), cache,
                             jnp.int32(s))
    dropped = []
    route = F._route

    def counting_route(xl, router, c):
        out = route(xl, router, c)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(F, "_route", counting_route)
    c = model.init_cache(B, s + 8, dtype=torch.float32)
    g0, c = model.prefill({"tokens": toks[:, :s]}, c)
    c0 = {k: {n: t.clone().numpy() for n, t in v.items()}
          for k, v in c.items()}
    g1, c = model.decode(toks[:, s:], c, s)
    assert len(dropped) == 2 * cfg.n_layers
    if kind == "one_token":
        assert sum(dropped) > 0
    for got, want in ((g0, lg0), (g1, lg1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    for got_c, want_c in ((c0, cache0),
                          ({k: {n: t.numpy() for n, t in v.items()}
                            for k, v in c.items()}, _np_tree(cache1))):
        for layer, tensors in want_c.items():
            for name, want in tensors.items():
                np.testing.assert_allclose(got_c[layer][name], want,
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{layer}.{name}")


# ------------------------------------------------------------------ serving

def _serve(replica, request_cls, prompts, steps=40):
    """Admit requests as slots free up; step until all are done."""
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


def test_moe_replica_tokens_equal_reference():
    ref_cfg = ref_reduced_config(ref_get_config("granite_moe_3b"))
    cfg = reduced_config(get_config("granite_moe_3b"))
    ref = RefReplica(ref_cfg, make_local_mesh(), slots=3, max_len=48)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref.params)))
    port = Replica(cfg, "cpu", slots=3, max_len=48, params=model)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 30, 12, 9)]
    want = _serve(ref, RefRequest, prompts)
    got = _serve(port, Request, prompts)
    assert len(want) == 4 and got == want


def test_serve_cli_runs_moe_on_cpu():
    out = serve.main(["--arch", "granite_moe_3b", "--requests", "4",
                      "--ticks", "60", "--prompt-len", "5", "--max-new", "3",
                      "--device", "cpu"])
    assert out["completed"] == 4 and out["throughput_tokens"] == 4 * 4
