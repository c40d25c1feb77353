"""The port's multi-device paths on 8 ``gloo`` ranks on the CPU, the
counterpart of ``tests/test_distributed.py`` (8 forced XLA host devices):

* ``train.compression.ef_allreduce_mean`` on 8 ranks of (8, 4096)
  gradients: within 3 % of the true mean, every rank's mean equal, the
  residual within the quantization step; against the JAX package's
  under 8 forced XLA devices (a subprocess, as the reference's tests
  run): the int8 ``q`` equal, the mean within 1e-6 relative, and the
  residual within one ulp of the gradient (XLA fuses ``y − q·scale``
  into one multiply-add; the port rounds the product);
* the sharded train step: ``tests/test_torch_distributed_train.py``;
* MoE on a (2, 4) layout against the port's (1, 1) and the JAX
  package's replicated output (reduced granite-moe-3b, ``d_ff`` 64,
  ``CAPACITY_FACTOR`` 64 on both packages so that nothing is dropped),
  atol 2e-5 and rtol 2e-4;
* the elastic restore: saved from (8, 1), restored to (2, 4) with the
  placements asked for and every leaf equal; a checkpoint written by the
  JAX package restores on the port's (2, 4).

Each test spawns its own group of ranks once, from a ``file://`` store
under ``tmp_path`` (no TCP port), one thread a rank, with a deadline.
The rank functions import no JAX: a rank imports this module by name.
"""

import datetime
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
DEADLINE = 240.0


def _spawn(fn, tmp_path, *args, world: int = WORLD):
    """Runs ``fn(rank, world, dir, *args)`` on ``world`` spawned ranks and
    fails the test if one fails or the group outlives ``DEADLINE``."""
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path), fn)
                             + args, nprocs=world, join=False,
                             start_method="spawn")
    end = time.time() + DEADLINE
    while not ctx.join(timeout=max(1.0, end - time.time())):
        if time.time() > end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: ranks outlived {DEADLINE} s")


def _rank_main(rank, world, d, fn, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, world, d, *args)
    finally:
        dist.destroy_process_group()


def _run_jax8(code: str) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# ------------------------------------------------------------ compression

def _ef_rank(rank, world, d):
    from repro_torch.train import compression as C
    g = torch.from_numpy(np.load(f"{d}/g.npy")[rank:rank + 1])
    mean, err = C.ef_allreduce_mean(g, torch.zeros_like(g))
    q, scale = C.quantize_int8(g)
    np.savez(f"{d}/ef{rank}.npz", mean=mean.numpy(), err=err.numpy(),
             q=q.numpy(), scale=scale.numpy())


def test_int8_ef_allreduce_matches_psum(tmp_path):
    g = (np.random.default_rng(0).standard_normal((WORLD, 4096))
         * 2.0).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    _spawn(_ef_rank, tmp_path)
    r = [np.load(tmp_path / f"ef{i}.npz") for i in range(WORLD)]
    mean = np.concatenate([x["mean"] for x in r])
    err = np.concatenate([x["err"] for x in r])
    q = np.concatenate([x["q"] for x in r])
    true = g.mean(0)
    rel = np.abs(mean[0] - true).max() / np.abs(true).max()
    assert rel < 0.03, rel                      # int8, one shot
    assert np.all(mean == mean[0:1]), "ranks disagree"
    q_step = np.abs(g).max() / 127.0
    assert np.abs(err).max() <= q_step + 1e-6

    # The JAX package's, on the same gradients under 8 XLA devices.
    _run_jax8(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        from repro.train import compression as C
        mesh = Mesh(np.array(jax.devices()).reshape(8), ("dp",))
        g = jnp.asarray(np.load("{tmp_path}/g.npy"))
        spec = P("dp")
        def body(g, e):
            mean, err = C.ef_allreduce_mean(g, e, "dp")
            q, _ = C.quantize_int8(g + e, "dp")
            return mean, err, q
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec, spec),
                               check_vma=False))
        mean, err, q = fn(g, jnp.zeros_like(g))
        np.savez("{tmp_path}/ref.npz", mean=np.asarray(mean),
                 err=np.asarray(err), q=np.asarray(q))
    """)
    ref = np.load(tmp_path / "ref.npz")
    np.testing.assert_array_equal(q, ref["q"])
    np.testing.assert_allclose(mean, ref["mean"], rtol=1e-6,
                               atol=1e-6 * np.abs(ref["mean"]).max())
    # The residual y − q·scale: XLA on the CPU contracts it into one
    # fused multiply-add, the port rounds the product first, so an
    # element may move by up to one ulp of y (73 % of them do here).
    assert np.all(np.abs(err - ref["err"]) <= np.spacing(np.abs(g)))


# -------------------------------------------------------------------- MoE

def _moe_cfg():
    from repro_torch.configs.base import get_config, reduced_config
    return reduced_config(get_config("granite_moe_3b"), d_ff=64)


def _moe_rank(rank, world, d):
    from torch.distributed.tensor import distribute_tensor
    import repro_torch.models.mlp as F
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import AxisSizes
    F.CAPACITY_FACTOR = 64.0          # as the reference's test sets it
    cfg = _moe_cfg()
    layout = make_mesh((2, 4), ("data", "model"))
    ax = AxisSizes.from_mesh(layout)
    data = np.load(f"{d}/moe.npz")
    specs = F.moe_specs(cfg, ax)
    p = {k: distribute_tensor(torch.from_numpy(data[k]), ax.mesh,
                              ax.placements(specs[k]), src_data_rank=None)
         for k in specs}
    assert p["w1"].placements[1].is_shard(2)       # d_ff over model
    x = distribute_tensor(torch.from_numpy(data["x"]), ax.mesh,
                          ax.placements((None, None, None)),
                          src_data_rank=None)
    out = F.moe_mlp(p, x, cfg, ax).full_tensor()
    if rank == 0:
        np.save(f"{d}/moe_out.npy", out.numpy())


def test_moe_ep_sharded_matches_replicated(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    import repro.models.mlp as ref_mlp
    import repro_torch.models.mlp as F
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced_config as ref_reduced_config
    from repro.launch.mesh import make_local_mesh
    from repro.models.common import AxisSizes as RefAxisSizes
    from repro.models.common import KeyGen as RefKeyGen

    monkeypatch.setattr(ref_mlp, "CAPACITY_FACTOR", 64.0)
    monkeypatch.setattr(F, "CAPACITY_FACTOR", 64.0)
    rcfg = ref_reduced_config(ref_get_config("granite_moe_3b"), d_ff=64)
    p = ref_mlp.init_moe(RefKeyGen(jax.random.PRNGKey(0)), rcfg)
    x = np.random.default_rng(1).standard_normal(
        (4, 16, rcfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "moe.npz", x=x,
             **{k: np.asarray(v) for k, v in p.items()})
    _spawn(_moe_rank, tmp_path)
    sharded = np.load(tmp_path / "moe_out.npy").reshape(x.shape)

    mesh = make_local_mesh()
    ax = RefAxisSizes.from_mesh(mesh)
    ref = np.asarray(jax.jit(lambda p, x: ref_mlp.moe_mlp(
        p, x, rcfg, ax, mesh))(p, jnp.asarray(x)))
    one = F.moe_mlp({k: torch.from_numpy(np.array(v))
                     for k, v in p.items()}, torch.from_numpy(x),
                    _moe_cfg()).numpy()
    np.testing.assert_allclose(sharded, one, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(sharded, ref, atol=2e-5, rtol=2e-4)


# ---------------------------------------------------------- elastic restore

def _restore_rank(rank, world, d):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import AxisSizes
    from repro_torch.train.checkpoint import Checkpointer
    a = make_mesh((8, 1), ("data", "model"))
    b = make_mesh((2, 4), ("data", "model"))
    w = torch.arange(64.0).reshape(8, 8)
    ax = AxisSizes.from_mesh(a)
    wa = distribute_tensor(w, a.mesh, ax.placements(("data", "model")),
                           src_data_rank=None)
    ck = Checkpointer(f"{d}/port")
    ck.save(3, {"w": wa})
    tpl = {"w": torch.empty(8, 8, device="meta")}
    out, _ = ck.restore(3, tpl, layout=b, specs={"w": ("data", "model")})
    assert out["w"].device_mesh.shape == (2, 4)
    assert list(out["w"].placements) == [Shard(0), Shard(1)]
    assert out["w"].to_local().shape == (4, 2)
    assert torch.equal(out["w"].full_tensor(), w)
    # The JAX package's checkpoint, on the port's (2, 4).
    ref = Checkpointer(f"{d}/ref")
    want = dict(np.load(f"{d}/ref_leaves.npz"))
    tpl = {"params": {"w": torch.empty(8, 8, device="meta"),
                      "b": torch.empty(8, device="meta")}}
    specs = {"params": {"w": ("data", "model"), "b": (None,)}}
    out, meta = ref.restore(7, tpl, layout=b, specs=specs)
    assert meta == {"step": 7}
    assert list(out["params"]["b"].placements) == [Replicate(), Replicate()]
    assert out["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"].full_tensor(),
                       torch.from_numpy(want["w"]))
    assert torch.equal(out["params"]["b"].full_tensor().float(),
                       torch.from_numpy(want["b"]))
    if rank == 0:
        open(f"{d}/restore.ok", "w").write("ok")


def test_checkpoint_elastic_reshard_across_meshes(tmp_path):
    import jax.numpy as jnp
    from repro.train.checkpoint import Checkpointer as RefCheckpointer
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8) * 0.5
    b = np.linspace(-1, 1, 8).astype(np.float32)
    RefCheckpointer(str(tmp_path / "ref")).save(
        7, {"params": {"w": jnp.asarray(w),
                       "b": jnp.asarray(b, jnp.bfloat16)}},
        metadata={"step": 7})
    np.savez(tmp_path / "ref_leaves.npz", w=w,
             b=np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32)))
    _spawn(_restore_rank, tmp_path)
    assert (tmp_path / "restore.ok").exists()
