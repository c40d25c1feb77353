"""The port's dense ``Model`` against the JAX package's, on the CPU.

The JAX model's ``init(0)`` weights go through
``convert.params_from_jax`` into the port's ``Model``; both then prefill
the same numpy-seeded prompts and decode one more token, at one scalar
position and at per-row positions. Reduced gemma2_2b (4 layers, d 64,
4 heads / 2 kv, hd 16, window 64, softcaps) with an 80-token prompt,
past the window, and reduced smollm_135m (no window, no softcap). The
reference runs with ``impl="xla"`` and with ``impl="pallas"`` (the
Pallas kernels in interpret mode); the port with ``impl="torch"`` and
with ``impl="cuda"``, which on CPU tensors routes through
``kernels.ops`` to the kernels' plain versions. Tolerance: float32,
atol 5e-5 and rtol 5e-4, the reference's own between its paths
(``tests/test_models_consistency.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.mesh import make_local_mesh
from repro.models.transformer import Model as RefModel
from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model

ATOL, RTOL = 5e-5, 5e-4
B = 2
PROMPT = {"gemma2_2b": 80, "smollm_135m": 24}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["gemma2_2b", "smollm_135m"])
def setup(request):
    arch = request.param
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    ref = RefModel(ref_cfg, make_local_mesh(), compute_dtype=jnp.float32)
    ref_params = ref.init(0)
    model = Model(cfg, "cpu", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(ref_params)))
    s = PROMPT[arch]
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, s + 1),
                                              dtype=np.int32)
    return arch, cfg, ref_cfg, ref_params, model, toks


def _ref_run(ref_cfg, params, toks, impl, pos_kind):
    s = toks.shape[1] - 1
    ref = RefModel(ref_cfg, make_local_mesh(), impl=impl,
                   compute_dtype=jnp.float32)
    cache = ref.init_cache(B, s + 8, dtype=jnp.float32)
    lg0, cache = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :s])},
                             cache)
    pos = jnp.int32(s) if pos_kind == "scalar" else \
        jnp.full((B,), s, jnp.int32)
    lg1, cache1 = ref.decode(params, jnp.asarray(toks[:, s:]), cache, pos)
    return (np.asarray(lg0), _np_tree(cache), np.asarray(lg1),
            _np_tree(cache1))


def _port_run(model, toks, impl, pos_kind):
    s = toks.shape[1] - 1
    m = model.with_impl(impl)
    cache = m.init_cache(B, s + 8, dtype=torch.float32)
    lg0, cache = m.prefill({"tokens": toks[:, :s]}, cache)
    cache0 = {k: {n: t.clone().numpy() for n, t in v.items()}
              for k, v in cache.items()}
    pos = s if pos_kind == "scalar" else torch.full((B,), s)
    lg1, cache = m.decode(toks[:, s:], cache, pos)
    cache1 = {k: {n: t.numpy() for n, t in v.items()}
              for k, v in cache.items()}
    return lg0.numpy(), cache0, lg1.numpy(), cache1


@pytest.mark.parametrize("pos_kind", ["scalar", "per_row"])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("pallas", "cuda"),
                                           ("xla", "cuda")])
def test_prefill_and_decode_match_reference(setup, ref_impl, impl, pos_kind):
    arch, cfg, ref_cfg, ref_params, model, toks = setup
    want = _ref_run(ref_cfg, ref_params, toks, ref_impl, pos_kind)
    got = _port_run(model, toks, impl, pos_kind)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[2], want[2], atol=ATOL, rtol=RTOL)
    for cache_got, cache_want in ((got[1], want[1]), (got[3], want[3])):
        assert cache_got.keys() == cache_want.keys()
        for layer in cache_want:
            for name in ("k", "v"):
                np.testing.assert_allclose(cache_got[layer][name],
                                           cache_want[layer][name],
                                           atol=ATOL, rtol=RTOL)


def test_params_round_trip_names_and_shapes(setup):
    arch, cfg, ref_cfg, ref_params, model, toks = setup
    state = params_from_jax(_np_tree(ref_params))
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert tuple(t.shape) == tuple(state[name].shape), name
        assert torch.equal(t, state[name]), name


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_decode_matches_full(setup, impl):
    """Prefill S-1 tokens, decode the last one: the same logits as the
    full-sequence forward's last position (the port alone)."""
    arch, cfg, ref_cfg, ref_params, model, toks = setup
    s = toks.shape[1]
    m = model.with_impl(impl)
    cache = m.init_cache(B, s, dtype=torch.float32)
    _, cache = m.prefill({"tokens": toks[:, :s - 1]}, cache)
    lg_a, _ = m.decode(toks[:, s - 1:], cache, s - 1)
    lg_b = m(torch.as_tensor(toks))[:, -1:, :]
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [None, 24])
def test_qchunked_plain_attention_matches_reference(monkeypatch, window):
    """The plain path's query-chunked attention (sequences above
    ``CHUNK_THRESHOLD``, banded on window layers), with both packages'
    chunk sizes shrunk so a short sequence takes it."""
    from repro.models import attention as ref_attn
    from repro.models.common import AxisSizes
    from repro_torch.models import attention as attn
    for mod in (ref_attn, attn):
        monkeypatch.setattr(mod, "CHUNK_Q", 32)
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 64)
    cfg = dataclasses.replace(reduced_config(get_config("gemma2_2b")),
                              sliding_window=window)
    ref_cfg = dataclasses.replace(
        ref_reduced_config(ref_get_config("gemma2_2b")),
        sliding_window=window)
    rng = np.random.default_rng(7)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wq", (64, 4, 16)), ("wk", (64, 2, 16)),
                      ("wv", (64, 2, 16)), ("wo", (4, 16, 64)))}
    x = rng.standard_normal((2, 128, 64)).astype(np.float32)
    want = ref_attn.attend_full({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), ref_cfg, AxisSizes.single(),
                                local=window is not None)
    got = attn.attend_full({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), cfg, local=window is not None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_random_init_is_seeded_and_scaled():
    cfg = reduced_config(get_config("gemma2_2b"))
    a = Model(cfg, "cpu").init(3)
    b = Model(cfg, "cpu").init(3)
    c = Model(cfg, "cpu").init(4)
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if "norm" not in name:
            assert not torch.equal(x, z), name
    wq = a.blocks["l0"].mix["wq"]
    std = cfg.d_model ** -0.5
    assert float(wq.abs().max()) <= 2 * std
    assert abs(float(wq.std()) / std - 0.88) < 0.1   # truncated at ±2σ


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_constructs(arch):
    """Every architecture of the configs builds on the CPU, and its
    state dict holds the flattened JAX parameter tree: the same names,
    shapes and dtypes (the reference's tree from ``jax.eval_shape``)."""
    cfg = reduced_config(get_config(arch), vocab=256)
    ref_cfg = ref_reduced_config(ref_get_config(arch), vocab=256)
    model = Model(cfg, "cpu").init(0)
    tree = jax.eval_shape(RefModel(ref_cfg, make_local_mesh()).init, 0)
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {name: (tuple(t.shape), str(t.dtype)[6:])
            for name, t in model.state_dict().items()} == want


def test_impl_resolution_and_device():
    cfg = reduced_config(get_config("smollm_135m"))
    assert Model(cfg, "cpu").impl == "torch"
    assert Model(cfg, "cpu").with_impl("cuda").impl == "cuda"
    with pytest.raises(ValueError, match="impl"):
        Model(cfg, "cpu", impl="pallas")
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "labels": np.ones((1, 4), np.int32)}
    loss = Model(cfg, "cpu").init(0).loss(batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            Model(cfg)
