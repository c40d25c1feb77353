"""The port's training loss and its gradients against the JAX package's,
on the CPU.

``Model.loss`` and every parameter's gradient (autograd) against the
reference's ``Model(impl="xla").loss`` and ``jax.value_and_grad`` — the
path the reference's trainer differentiates — on the reduced config of
each family: dense with softcaps and local layers (gemma2), dense
(smollm), MoE (granite-moe), SSM (mamba2), the hybrid (jamba), and the
vlm / audio models with the ``SyntheticLM`` frontend (llama-vision,
whisper). Weights: the reference's ``init(0)`` through
``convert.params_from_jax``; float32 weights and compute; the batch is
``SyntheticLM.batch_at(0)``, the same arrays in both packages.

Tolerance (float32): the loss within rtol 1e-5; each gradient leaf
within 5e-4 of that leaf's largest magnitude (the two packages sum in
different orders; the SSD scan's ``A_log`` gradients, summed along the
sequence, differ most, 1.1e-4 of their scale in jamba).

Also: one ``make_train_step`` step with ``accum_steps=2`` (two
micro-batches, float32 gradients averaged) against the reference's, its
loss, ``grad_norm`` (rtol 1e-4) and updated weights (atol 1e-5, 1 % of
the step at lr 1e-3); remat leaves the gradients unchanged; a float64
model evaluates in float64 throughout.
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
from repro.train.optimizer import adamw as ref_adamw
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models.common import rms_norm, softcap, upcast
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw
from repro_torch.train.trainer import make_train_step

ARCHS = ["gemma2_2b", "smollm_135m", "granite_moe_3b", "mamba2_130m",
         "jamba15_large_398b", "llama32_vision_90b", "whisper_base"]
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4       # of each leaf's largest |gradient|
# AdamW's first step is g / (|g| + eps): where |g| is near eps = 1e-8 the
# gradients' rounding moves it. 1e-5 is 1 % of the step at lr 1e-3.
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def setup(arch, remat=True):
    """(reference model, its params, the port's Model with them, batch)."""
    ref_cfg = ref_reduced_config(ref_get_config(arch), remat=remat)
    cfg = reduced_config(get_config(arch), remat=remat)
    ref = RefModel(ref_cfg, make_local_mesh(), compute_dtype=jnp.float32)
    params = ref.init(0)
    model = Model(cfg, "cpu", impl="torch", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    model.requires_grad_(True)
    batch = SyntheticLM(cfg, B, S).batch_at(0)
    return ref, params, model, batch


def port_loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_TOL * scale + 1e-12, (name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    ref, params, model, batch = setup(arch)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, grads = port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, params_from_jax(_np_tree(want_grads)))


def test_remat_leaves_gradients_unchanged():
    """Recomputing each period in the backward pass (cfg.remat, the
    default) gives the gradients of the plain backward, bit for bit."""
    *_, model, batch = setup("gemma2_2b")
    *_, plain, _ = setup("gemma2_2b", remat=False)
    assert model.cfg.remat and not plain.cfg.remat
    loss_r, grads_r = port_loss_and_grads(model, batch)
    loss_p, grads_p = port_loss_and_grads(plain, batch)
    assert loss_r == loss_p
    for name in grads_p:
        assert torch.equal(grads_r[name], grads_p[name]), name


def test_serving_models_build_no_graph():
    """Weights are created without requires_grad: a model that no trainer
    took builds no graph, even for a loss outside no_grad."""
    cfg = reduced_config(get_config("smollm_135m"))
    model = Model(cfg, "cpu", impl="torch",
                  compute_dtype=torch.float32).init(0)
    assert not any(p.requires_grad for p in model.parameters())
    assert model.loss(SyntheticLM(cfg, B, S).batch_at(0)).grad_fn is None


def test_float64_model_evaluates_in_float64():
    """The same weights in float64 (weights and compute): the loss is
    float64 and within float32's rounding of the float32 loss; the
    norms, softcaps, RoPE and softmax run in float64, not float32."""
    ref, params, model, batch = setup("gemma2_2b")
    m64 = Model(model.cfg, "cpu", impl="torch", compute_dtype=torch.float64,
                param_dtype=torch.float64)
    m64.load_state_dict(params_from_jax(_np_tree(params)))
    m64.double()
    with torch.no_grad():
        l64 = m64.loss(batch)
        l32 = model.loss(batch)
    assert l64.dtype == torch.float64
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-6)
    # the reference's float32 steps run in float64 for float64 tensors
    x = torch.linspace(-80.0, 80.0, 1001, dtype=torch.float64)
    assert torch.equal(softcap(x, 30.0), 30.0 * torch.tanh(x / 30.0))
    w = torch.zeros(1001, dtype=torch.float32)
    assert torch.equal(rms_norm(x, w),
                       x * torch.rsqrt(torch.mean(x * x) + 1e-6))
    assert upcast(torch.bfloat16) == torch.float32


def test_accumulated_train_step_matches_reference():
    """``accum_steps=2``: the reference's ``make_train_step`` (a
    ``lax.scan`` over two micro-batches, float32 accumulation, AdamW)
    and the port's (a loop), one step from the same weights."""
    arch = "smollm_135m"
    ref, params, _, _ = setup(arch)
    cfg = reduced_config(get_config(arch))
    model = Model(cfg, "cpu", impl="torch", compute_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    model.requires_grad_(True)
    batch = SyntheticLM(cfg, 4, S).batch_at(3)
    opt_ref = ref_adamw()
    step = jax.jit(ref_make_train_step(ref, opt_ref, accum_steps=2))
    want_p, _, want_m = step(params, opt_ref.init(params),
                             jax.tree.map(jnp.asarray, batch),
                             jnp.float32(1e-3))
    opt = adamw()
    tree = model.params()
    _, state, metrics = make_train_step(model, opt, accum_steps=2)(
        tree, opt.init(tree), batch, 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(want_m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-4)
    assert int(state["count"]) == 1
    want = params_from_jax(_np_tree(want_p))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)
        assert p.grad is None, name
