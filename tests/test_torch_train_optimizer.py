"""The port's optimizers against the JAX package's, on the CPU.

* ``adamw`` and ``adafactor``: five updates on the same numpy-seeded
  gradients from the same parameters (leaves of 1, 2 and 3 dimensions,
  one bfloat16), parameters and every state leaf against the
  reference's; the port updates in place. Tolerance (float32): rtol
  1e-5 and atol 1e-6 (the two sum the clip's norm in different orders;
  the bfloat16 leaf, one of its ulps).
* ``clip_by_global_norm`` and the global norm as the reference's.
* The reference's convergence tests (a quadratic, 60 steps) and
  adafactor's factored state shapes, mirrored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as opt

ATOL, RTOL = 1e-6, 1e-5
SHAPES = {"w": (6, 5), "b": (5,), "blocks": {"m": (3, 4, 7),
                                             "s": ()}}


def _leaves(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _leaves(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _jax(tree, bf16=()):
    return {k: _jax(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _torch(tree):
    """A JAX tree as torch tensors of the same dtypes, nested."""
    return {k: _torch(v) if isinstance(v, dict) else
            params_from_jax({"a": np.asarray(v)})["a"]
            for k, v in tree.items()}


def _assert_trees_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
        return
    want_t = params_from_jax({"a": np.asarray(want)})["a"]
    assert got.dtype == want_t.dtype, path
    np.testing.assert_allclose(got.float().numpy(), want_t.float().numpy(),
                               atol=ATOL, rtol=RTOL if got.dtype !=
                               torch.bfloat16 else 1e-2, err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference(name):
    rng = np.random.default_rng(5)
    params_np = _leaves(SHAPES, rng, 1.0)
    ref = getattr(ref_opt, name)()
    port = getattr(opt, name)()
    ref_p = _jax(params_np, bf16=("b",))
    ref_s = ref.init(ref_p)
    p = _torch(ref_p)
    s = port.init(p)
    ids = {k: id(v) for k, v in p.items() if not isinstance(v, dict)}
    for step in range(5):
        # step 2's gradients are large enough for the clip to act
        g_np = _leaves(SHAPES, rng, 10.0 if step == 2 else 0.05)
        ref_p, ref_s = ref.update(_jax(g_np), ref_s, ref_p,
                                  jnp.float32(1e-2))
        p2, s2 = port.update(_torch(_jax(g_np)), s, p, 1e-2)
        assert p2 is p and s2 is s
    assert {k: id(v) for k, v in p.items() if not isinstance(v, dict)} \
        == ids
    _assert_trees_close(p, ref_p)
    _assert_trees_close(s, ref_s)
    assert int(s["count"]) == 5 and s["count"].dtype == torch.int32


def test_clip_and_norm_match_reference():
    rng = np.random.default_rng(2)
    g = _leaves(SHAPES, rng, 3.0)
    want_norm = ref_opt._global_norm(_jax(g))
    got = _torch(_jax(g))
    np.testing.assert_allclose(float(opt.global_norm(got)), float(want_norm),
                               rtol=RTOL)
    want = ref_opt.clip_by_global_norm(_jax(g), 1.0)
    leaf = got["w"]
    clipped = opt.clip_by_global_norm(got, 1.0)
    assert clipped["w"] is leaf          # float32 leaves scaled in place
    _assert_trees_close(clipped, want)
    # below the limit nothing changes
    small = _torch(_jax(_leaves(SHAPES, rng, 1e-3)))
    before = {k: v.clone() for k, v in small.items()
              if not isinstance(v, dict)}
    opt.clip_by_global_norm(small, 1.0)
    for k, v in before.items():
        assert torch.equal(small[k], v), k


def _quadratic_losses(o, steps=60):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3, requires_grad=True),
              "m": torch.zeros(2, 3, requires_grad=True)}

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum(p["m"] ** 2)

    state = o.init(params)
    losses = []
    for _ in range(steps):
        for p in params.values():
            p.grad = None
        loss_fn(params).backward()
        grads = {k: p.grad for k, p in params.items()}
        params, state = o.update(grads, state, params, 0.1)
        with torch.no_grad():
            losses.append(float(loss_fn(params)))
    return losses


def test_adamw_converges():
    losses = _quadratic_losses(opt.adamw(weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_converges_and_is_factored():
    o = opt.adafactor()
    losses = _quadratic_losses(o)
    assert losses[-1] < 0.2 * losses[0]
    state = o.init({"m": torch.zeros(8, 16)})
    assert state["v"]["m"]["vr"].shape == (8,)
    assert state["v"]["m"]["vc"].shape == (16,)
    state = o.init({"t": torch.zeros(2, 8, 16), "b": torch.zeros(16)})
    assert state["v"]["t"]["vr"].shape == (2, 8)
    assert state["v"]["t"]["vc"].shape == (2, 16)
    assert state["v"]["b"]["v"].shape == (16,)


def test_state_trees_have_the_reference_keys():
    params = {"w": np.zeros((4, 4), np.float32),
              "b": np.zeros((4,), np.float32)}
    for name in ("adamw", "adafactor"):
        want = getattr(ref_opt, name)().init(_jax(params))
        got = getattr(opt, name)().init(_torch(_jax(params)))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(got), name
    assert opt.get_optimizer("adafactor", lr=1e-2) is not None
    with pytest.raises(KeyError):
        opt.get_optimizer("sgd")
