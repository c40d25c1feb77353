"""The sharded train step on 8 ``gloo`` ranks on the CPU, the
counterpart of ``tests/test_distributed.py``'s train-step test (8 forced
XLA host devices); the groups are spawned as in
``tests/test_torch_distributed.py``.

AdamW, ``accum_steps=2``, 3 steps from the JAX package's ``init(0)``
weights: reduced smollm-135m (vocab 512) on a (4, 2) layout with 8 rows
and with 12 (a micro-batch of 6 rows on 4 batch ranks, whole on each),
reduced granite-moe-3b (``d_ff`` 64, ``CAPACITY_FACTOR`` 64 on both
packages) on (2, 4), and reduced mamba2-130m on (4, 2). Each loss within
rtol 1e-5 of the port's one-device run and of the JAX package's; the
whole batch's gradients at the initial weights within 1e-5 of each
leaf's largest against one device's (the backward rules of the per-rank
layers); the updated weights within atol 1e-5 (ROADMAP §C's AdamW
note), except where the first gradient is within 10 eps of 0, where
AdamW's first step is set by rounding and the check is the steps' own
bound, ``STEPS · lr``.
"""

import numpy as np
import pytest
import torch

from test_torch_distributed import _spawn


# ----------------------------------------------------- sharded train step

STEPS, ACCUM, LR = 3, 2, 1e-3
ADAM_EPS = 1e-8            # the optimizer's
GRAD_TOL = 1e-5            # of each leaf's largest gradient
# name: (arch, reduced_config overrides, layout, batch rows, MoE capacity
# factor or None). smollm_b12: 12 rows on 4 batch ranks, so a
# micro-batch of 6 rows does not divide them (it is whole on each).
TRAIN_CASES = {
    "smollm": ("smollm_135m", {"vocab": 512}, (4, 2), 8, None),
    "smollm_b12": ("smollm_135m", {"vocab": 512}, (4, 2), 12, None),
    "granite_moe": ("granite_moe_3b", {"d_ff": 64}, (2, 4), 8, 64.0),
    "mamba2": ("mamba2_130m", {}, (4, 2), 8, None),
}


def _train_cfg(case):
    from repro_torch.configs.base import get_config, reduced_config
    arch, over = TRAIN_CASES[case][:2]
    return reduced_config(get_config(arch), **over)


def _train_port(model, batch):
    """``STEPS`` steps of ``make_train_step``; the losses."""
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import make_train_step
    model.requires_grad_(True)
    opt = get_optimizer("adamw", lr=LR)
    params = model.params()
    state = opt.init(params)
    step = make_train_step(model, opt, accum_steps=ACCUM,
                           grad_pspecs=model.param_specs()
                           if model.mesh is not None else None)
    losses = []
    for _ in range(STEPS):
        _, _, m = step(params, state, batch, LR)
        losses.append(float(m["loss"]))
    return losses


def _first_grads(model, batch):
    """The whole batch's loss gradients at the current weights (whole
    tensors), left off the parameters."""
    model.requires_grad_(True)
    model.loss(batch).backward()
    out = {}
    for n, p in model.named_parameters():
        g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") \
            else p.grad
        out[n] = g.detach().numpy().copy()
        p.grad = None
    return out


def _train_rank(rank, world, d, case):
    import repro_torch.models.mlp as F
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.train.trainer import batch_pspecs
    _, _, shape, _, capacity = TRAIN_CASES[case]
    if capacity is not None:
        F.CAPACITY_FACTOR = capacity      # as the reference's test sets it
    layout = make_mesh(shape, ("data", "model"))
    model = Model(_train_cfg(case), layout, impl="torch",
                  compute_dtype=torch.float32)
    state = {k: torch.from_numpy(v) for k, v in
             np.load(f"{d}/init.npz").items()}
    model.place_(state)
    data = np.load(f"{d}/batch.npz")
    ax = model.ax
    specs = batch_pspecs(model.cfg, ax)
    from torch.distributed.tensor import distribute_tensor
    batch = {k: distribute_tensor(torch.from_numpy(data[k]), ax.mesh,
                                  ax.placements(specs[k]),
                                  src_data_rank=None)
             for k in ("tokens", "labels")}
    assert batch["tokens"].placements[0].is_shard(0)
    grads = _first_grads(model, batch)
    losses = _train_port(model, batch)
    final = {n: p.full_tensor().detach().numpy()
             for n, p in model.named_parameters()}
    placed = {n: str(p.placements) for n, p in model.named_parameters()}
    if rank == 0:
        np.savez(f"{d}/sharded.npz", losses=np.array(losses), **final)
        np.savez(f"{d}/grads.npz", **grads)
        with open(f"{d}/placements.txt", "w") as f:
            f.write(repr(placed))


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_single_device(case, tmp_path,
                                                  monkeypatch):
    import jax
    import jax.numpy as jnp
    import repro.models.mlp as ref_mlp
    import repro_torch.models.mlp as F
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced_config as ref_reduced_config
    from repro.launch.mesh import make_local_mesh
    from repro.models.transformer import Model as RefModel
    from repro.train.optimizer import get_optimizer as ref_get_optimizer
    from repro.train.trainer import make_train_step as ref_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.transformer import Model

    arch, over, shape, rows, capacity = TRAIN_CASES[case]
    if capacity is not None:
        monkeypatch.setattr(ref_mlp, "CAPACITY_FACTOR", capacity)
        monkeypatch.setattr(F, "CAPACITY_FACTOR", capacity)
    rcfg = ref_reduced_config(ref_get_config(arch), **over)
    ref_model = RefModel(rcfg, make_local_mesh(), compute_dtype=jnp.float32)
    ref_params = ref_model.init(0)
    init = params_from_jax(jax.tree.map(np.asarray, ref_params))
    rng = np.random.default_rng(0)
    vocab = rcfg.vocab
    batch = {"tokens": rng.integers(0, vocab, (rows, 32)).astype(np.int32),
             "labels": rng.integers(0, vocab, (rows, 32)).astype(np.int32)}
    np.savez(tmp_path / "init.npz", **{k: v.numpy()
                                       for k, v in init.items()})
    np.savez(tmp_path / "batch.npz", **batch)
    _spawn(_train_rank, tmp_path, case)
    sharded = np.load(tmp_path / "sharded.npz")
    placed = eval(open(tmp_path / "placements.txt").read())
    sharded_on_model = [n for n, pl in placed.items()
                        if "Shard" in pl.split(",")[-1]]
    assert sharded_on_model, placed          # weights split over "model"

    # The port on one device.
    one = Model(_train_cfg(case), "cpu", impl="torch",
                compute_dtype=torch.float32).place_(init)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    one_grads = _first_grads(one, tb)
    one_losses = _train_port(one, tb)
    # The JAX package on one device.
    opt = ref_get_optimizer("adamw", lr=LR)
    state = opt.init(ref_params)
    step = jax.jit(ref_step(ref_model, opt, accum_steps=ACCUM))
    params, ref_losses = ref_params, []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(STEPS):
        params, state, m = step(params, state, jb, jnp.float32(LR))
        ref_losses.append(float(m["loss"]))

    np.testing.assert_allclose(sharded["losses"], one_losses, rtol=1e-5)
    np.testing.assert_allclose(sharded["losses"], ref_losses, rtol=1e-5)
    # The backward rules: the sharded gradients against one device's.
    grads = np.load(tmp_path / "grads.npz")
    for name, g in one_grads.items():
        np.testing.assert_allclose(grads[name], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=name)
    # The weights. Where the first gradient is within 10 eps of 0,
    # AdamW's first step g / (|g| + eps) is set by the summation order's
    # rounding (ROADMAP §C): there the check is the steps' own bound.
    ref_final = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in one.named_parameters():
        flat = np.abs(one_grads[name]) < 10 * ADAM_EPS
        for want in (p.detach().numpy(), ref_final[name].numpy()):
            np.testing.assert_allclose(sharded[name][~flat], want[~flat],
                                       atol=1e-5, err_msg=name)
            assert np.all(np.abs(sharded[name][flat] - want[flat])
                          <= STEPS * LR), name
