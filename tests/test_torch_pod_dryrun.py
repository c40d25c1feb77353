"""The dry run's pod layouts: the port's sharding specs and per-card
counts against the JAX package's, on the CPU.

* ``Model.param_specs``, ``Model.cache_pspecs`` (each serve shape's
  cache), ``trainer.batch_pspecs`` and ``Optimizer.state_specs`` equal
  the reference's for all ten architectures at full size, under its
  16 × 16 and 2 × 16 × 16 layouts. They are pure functions of the axis
  sizes: the reference's ``Model`` is built over a stand-in mesh (axis
  names and a device array of the layout's shape); the port's over a
  real layout of PyTorch's ``fake`` process group, on the meta device,
  whose cache shapes must be the reference's too.
* ``hlo_analysis.collective_bytes`` on the reference test's program: 13
  trips of an all-gather of f32[64, 1024] give ``64*1024*4*13`` bytes
  and a count of 13.
* The per-card argument bytes of a reduced train cell on a 4 × 2 layout
  (parameters, optimizer state, batch) equal the reference's
  ``memory_analysis().argument_size_in_bytes`` under 8 forced XLA
  devices, less the reference's float32 learning-rate argument (the
  port's step takes a Python float).
* The collectives of three reduced cells on a 4 × 2 layout (gemma2-2b
  and granite-moe-3b ``train_4k``, gemma2-2b ``decode_32k``) against
  the reference's HLO under 8 forced XLA devices, in elements (XLA's CPU
  backend widens bfloat16 collectives to float32, so bytes would
  compare dtypes): the total within a factor 2 of the reference's, and a
  train cell's all-reduce elements too. The split by kind is not held:
  the port reduce-scatters a gradient to its shards where XLA
  all-reduces it and slices.
* Two full-size pod cells, gemma2-2b ``train_4k`` and mamba2-130m
  ``decode_32k`` under 16 × 16, report ``status: ok``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"singlepod": False, "multipod": True}


@pytest.fixture(params=sorted(LAYOUTS))
def pod(request):
    """The reference's pod layout over a ``fake`` process group of its
    size (torn down after the test)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    multi = LAYOUTS[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        yield multi, make_production_mesh(multi_pod=multi)
    finally:
        dist.destroy_process_group()


class _StandInMesh:
    """What the reference's ``Model`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)
        self.size = int(np.prod(shape))


def _ref_model(arch, layout, param_dtype=None):
    import jax.numpy as jnp
    from repro.configs.base import get_config as ref_get_config
    from repro.models.transformer import Model as RefModel
    return RefModel(ref_get_config(arch),
                    _StandInMesh(layout.shape, layout.axes),
                    param_dtype=param_dtype or jnp.float32)


def _norm(tree):
    """A spec tree with the reference's PartitionSpecs as tuples."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_batch_and_state_specs_equal_reference(pod, arch):
    from repro.train.optimizer import get_optimizer as ref_get_optimizer
    from repro.train.trainer import batch_pspecs as ref_batch_pspecs
    from repro_torch.models.transformer import Model
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import batch_pspecs
    _, layout = pod
    cfg = get_config(arch)
    model = Model(cfg, layout, impl="torch")
    ref = _ref_model(arch, layout)
    want = _norm(ref.param_specs())
    got = model.param_specs()
    assert got == want
    assert _norm(ref_batch_pspecs(ref.cfg, ref.ax)) == \
        batch_pspecs(cfg, model.ax)
    assert _norm(ref_get_optimizer(cfg.optimizer).state_specs(
        ref.param_specs())) == get_optimizer(cfg.optimizer).state_specs(got)
    # Each weight is placed by its spec: a rank holds its shard only.
    embed = model.embed
    assert list(embed.placements) == model.ax.placements(got["embed"])
    assert embed.to_local().numel() < embed.numel()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(pod, arch):
    import jax
    import jax.numpy as jnp
    from repro_torch.models.transformer import Model
    _, layout = pod
    cfg = get_config(arch)
    model = Model(cfg, layout, impl="torch", param_dtype=torch.bfloat16)
    ref = _ref_model(arch, layout, jnp.bfloat16)
    checked = 0
    for name, shape in cfg.shapes().items():
        if shape.kind == "train" or shape.skip:
            continue
        ref_cache = jax.eval_shape(lambda: ref.init_cache(
            shape.global_batch, shape.seq_len, dtype=jnp.bfloat16))
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        shapes = jax.tree.map(lambda a: tuple(a.shape), ref_cache)
        assert {li: {k: tuple(t.shape) for k, t in lc.items()}
                for li, lc in cache.items()} == shapes, name
        want = _norm(ref.cache_pspecs(ref_cache))
        assert model.cache_pspecs(cache) == want, name
        for li, lc in cache.items():
            for k, t in lc.items():
                assert list(t.placements) == \
                    model.ax.placements(want[li][k]), (name, li, k)
        checked += 1
    assert checked >= 2


def test_collective_parser_on_sharded_module():
    """The reference's program: 13 trips, each an all-gather of a
    (1024, 64) float32 slice sharded over 8 ranks."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        layout = make_mesh((8,), ("data",))
        xs = distribute_tensor(torch.empty(13, 1024, 64, device="meta"),
                               layout.mesh, [Shard(1)], src_data_rank=None)

        def f(xs):
            # As XLA does for the reference's body: one all-gather of the
            # trip's slice, and both sums on the gathered copy.
            c = 0.0
            for x in xs.unbind(0):
                whole = x.redistribute(placements=[Replicate()])
                c = c + whole.sum(0).sum() + (whole @ whole.T).sum()
            return c

        cb = collective_bytes(f, xs)
    finally:
        dist.destroy_process_group()
    assert cb["all-gather"] == 64 * 1024 * 4 * 13, cb
    assert cb["_counts"]["all-gather"] == 13


def test_argument_bytes_equal_reference(tmp_path):
    """Reduced smollm-135m ``train_4k`` (global batch 256, one
    micro-batch) on a 4 × 2 layout."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_mesh
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent("""
        import jax, numpy as np
        from jax.sharding import Mesh
        import repro.launch.cells as C
        from repro.configs.base import get_config, reduced_config
        C.get_config = lambda arch: reduced_config(get_config(arch))
        mesh = Mesh(np.array(jax.devices()).reshape(4, 2),
                    ("data", "model"))
        cell = C.build_cell("smollm_135m", "train_4k", mesh)
        ma = C.lower_cell(cell).compile().memory_analysis()
        print("ARGS", ma.argument_size_in_bytes)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = int(out.stdout.split("ARGS")[1].split()[0])

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        layout = make_mesh((4, 2), ("data", "model"))
        cfg = reduced_config(get_config("smollm_135m"))
        counted = cells.count_cell(cells.build_cell(
            "smollm_135m", "train_4k", layout, cfg=cfg))
    finally:
        dist.destroy_process_group()
    lr_bytes = 4                      # the reference's float32 lr argument
    assert counted["argument_bytes"] + lr_bytes == want, (
        counted["argument_bytes"], want)


COLLECTIVE_CELLS = [("gemma2_2b", "train_4k"), ("granite_moe_3b", "train_4k"),
                    ("gemma2_2b", "decode_32k")]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
COLLECTIVE_BAND = 2.0


@pytest.fixture(scope="module")
def reference_collectives():
    """Each cell's collective elements by kind in the reference's
    compiled HLO (its own parser, every dtype counted one wide)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(f"""
        import json, jax, numpy as np
        from jax.sharding import Mesh
        import repro.launch.cells as C
        import repro.launch.hlo_analysis as H
        from repro.configs.base import get_config, reduced_config
        C.get_config = lambda arch: reduced_config(get_config(arch))
        H._shape_bytes = lambda dtype, dims: int(np.prod(
            [int(d) for d in dims.split(",") if d]))
        mesh = Mesh(np.array(jax.devices()).reshape(4, 2),
                    ("data", "model"))
        out = {{}}
        for arch, shape in {COLLECTIVE_CELLS!r}:
            hlo = C.lower_cell(C.build_cell(arch, shape, mesh)).compile()
            out[arch + "/" + shape] = H.collective_bytes(hlo.as_text())
        print("COLL", json.dumps(out))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return json.loads(out.stdout.split("COLL", 1)[1])


@pytest.mark.parametrize("arch,shape", COLLECTIVE_CELLS)
def test_collective_elements_near_reference(arch, shape,
                                            reference_collectives):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_mesh
    want = reference_collectives[f"{arch}/{shape}"]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        layout = make_mesh((4, 2), ("data", "model"))
        got = cells.count_cell(cells.build_cell(
            arch, shape, layout, cfg=reduced_config(get_config(arch))))
    finally:
        dist.destroy_process_group()
    got = got["collectives"]["_elements"]
    total = sum(got[k] for k in KINDS) / sum(want[k] for k in KINDS)
    print(f"{arch} {shape}: collective elements {total:.3f} x the "
          f"reference's; by kind (port, reference) "
          f"{ {k: (got[k], want[k]) for k in KINDS} }")
    assert 1 / COLLECTIVE_BAND <= total <= COLLECTIVE_BAND, (got, want)
    if shape == "train_4k":
        ar = got["all-reduce"] / want["all-reduce"]
        assert 1 / COLLECTIVE_BAND <= ar <= COLLECTIVE_BAND, (got, want)


@pytest.mark.parametrize("arch,shape", [("gemma2_2b", "train_4k"),
                                        ("mamba2_130m", "decode_32k")])
def test_full_size_pod_cells_are_ok(arch, shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        rec = dryrun.run_cell(arch, shape, make_production_mesh(), 256)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256
    forecast = rec["forecast"]
    assert 0 < forecast["peak_bytes"] < 80 * 2 ** 30
    assert rec["coll_bytes"] > 0
    assert sum(rec["collectives"]["_counts"].values()) > 0


def test_layouts_need_a_group_of_their_size():
    """No hidden fallback: a layout of N ranks needs a process group of
    N, and a description with no devices places nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models.transformer import Model
    cfg = reduced_config(get_config("smollm_135m"))
    with pytest.raises(RuntimeError, match="none is initialized"):
        make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="process group of 256 ranks"):
        Model(cfg, make_production_mesh())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        with pytest.raises(RuntimeError, match="has 8"):
            make_mesh((4, 4), ("data", "model"))
        assert make_production_mesh().mesh is None   # 256 ≠ 8
        layout = make_mesh((4, 2), ("data", "model"))
        assert layout.device.type == "meta" and layout.size == 8
        model = Model(cfg, layout, impl="torch")
        assert model.mesh is layout.mesh
    finally:
        dist.destroy_process_group()


def test_compression_on_one_rank(tmp_path):
    """K = 1: the ring is the identity, the mean is the int8 round trip
    and the residual what it lost."""
    from repro_torch.train import compression as C
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (3, 50)).astype(np.float32))
        err = C.init_error_state({"g": g})["g"]
        mean, new_err = C.ef_allreduce_mean(g, err)
        q, scale = C.quantize_int8(g)
        assert torch.equal(mean, q.float() * scale)
        torch.testing.assert_close(mean + new_err, g, rtol=0, atol=1e-6)
        tree, errs = C.ef_allreduce_tree({"a": {"g": g.double()}},
                                         {"a": {"g": err}})
        assert tree["a"]["g"].dtype == torch.float64
        assert errs["a"]["g"].dtype == torch.float32
    finally:
        dist.destroy_process_group()
