"""The port's cells (``repro_torch.launch.cells``, ``mesh``,
``hlo_analysis``) against the JAX package's ``repro.launch``.

* ``input_specs`` of all 40 cells: the reference's shapes and dtypes;
  the skip grid equals the reference's.
* ``model_flops_estimate`` equal for every cell; the ``Roofline`` terms,
  bottleneck and roofline fraction equal to the reference's for the same
  inputs (the reference's constants set to the port's H100 ones).
* ``analytic_cost`` at full depth equals the reference's extrapolation
  in depth, ``f1 + (f2 - f1)(n - 1)``, exactly; at gemma2-2b's full
  width it holds the reference's count as ``test_torch_dryrun.py``
  holds mamba2-130m's and granite-moe-3b's.
* The meta forecast of a reduced cell equals the same tracker's count of
  a real CPU run of the cell, byte for byte.
* Reduced granite-moe-3b and jamba build, prefill, decode and take a
  train step on the meta device; the static-shape MoE dispatch equals
  the boolean-indexed one bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.launch import cells as ref_cells
from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import cells, hlo_analysis
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import mlp

from test_torch_dryrun import check_against_reference

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}
META = make_local_mesh("meta")


def test_input_specs_and_skips_equal_reference():
    total = 0
    for arch, shape_name in CELLS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        shape, rshape = cfg.shapes()[shape_name], rcfg.shapes()[shape_name]
        got = cells.input_specs(cfg, shape)
        want = ref_cells.input_specs(rcfg, rshape)
        assert set(got) == set(want), (arch, shape_name)
        for name, sds in want.items():
            assert got[name].device.type == "meta"
            assert tuple(got[name].shape) == tuple(sds.shape)
            assert got[name].dtype == DTYPES[jnp.dtype(sds.dtype)]
        cell = cells.build_cell(arch, shape_name, META)
        assert cell.skip == rshape.skip
        assert (cell.build is None) == (rshape.skip is not None)
        # tests/test_models_smoke.py's rule: only SSM / hybrid run 500k
        if shape_name == "long_500k":
            assert (cell.skip is None) == (cfg.family in ("ssm", "hybrid"))
        total += 1
    assert total == 40


def test_model_flops_estimate_equals_reference():
    for arch, shape_name in CELLS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert hlo_analysis.model_flops_estimate(
            cfg, cfg.shapes()[shape_name]) == ref_hlo.model_flops_estimate(
            rcfg, rcfg.shapes()[shape_name])


ROOF_INPUTS = [  # (chips, flops, bytes, model_flops)
    (1, 2.3903e16, 2.892e14, 2.1e16), (1, 4.54e12, 5.37e12, 1.3e12),
    (1, 1.0, 5.0e9, None), (1, 8.6e15, 2.3e14, 8.5e15)]


@pytest.mark.parametrize("chips,flops,nbytes,model", ROOF_INPUTS)
def test_roofline_equals_reference(monkeypatch, chips, flops, nbytes, model):
    monkeypatch.setattr(ref_hlo, "PEAK_FLOPS", hlo_analysis.PEAK_FLOPS)
    monkeypatch.setattr(ref_hlo, "HBM_BW", hlo_analysis.HBM_BW)
    monkeypatch.setattr(ref_hlo, "ICI_BW", hlo_analysis.NVLINK_BW)
    want = ref_hlo.Roofline("a", "s", chips, flops, nbytes, 0.0, {},
                            model_flops=model, memory_per_device=3e9)
    got = hlo_analysis.analyze("a", "s", {"flops": flops, "bytes": nbytes,
                                          "peak_bytes": 3e9}, chips,
                               model_flops=model)
    for key in ("t_compute", "t_memory", "t_collective",
                "roofline_fraction"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=1e-12, err_msg=key)
    assert got.bottleneck == want.bottleneck
    assert got.row() == pytest.approx(want.row(), rel=1e-12)


def test_layouts():
    assert META.shape == (1, 1) and META.axes == ("data", "model")
    assert META.device.type == "meta" and META.size == 1
    pod = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.axes, pod.size) == ((16, 16), ("data", "model"),
                                               256)
    assert (two.shape, two.axes, two.size) == ((2, 16, 16),
                                               ("pod", "data", "model"), 512)
    # Without a process group of their size the pod layouts are
    # descriptions: a cell on one raises, naming the group it needs.
    assert pod.device is None and pod.mesh is None
    with pytest.raises(ValueError, match="process group of 256 ranks"):
        cells.build_cell("gemma2_2b", "decode_32k", pod)
    # On 256 cards the counts are one card's: the global FLOPs and bytes
    # are 256 times them, and the collective term is the card's own.
    roof = hlo_analysis.analyze("a", "s", {"flops": 1.0, "bytes": 1.0},
                                256)
    assert roof.hlo_flops == 256.0 and roof.t_collective == 0.0


DEPTH_CELLS = [("gemma2_2b", "prefill_32k"),
               ("whisper_base", "train_4k"), ("whisper_base", "decode_32k"),
               ("jamba15_large_398b", "decode_32k"),
               ("granite_moe_3b", "decode_32k"),
               ("mamba2_130m", "train_4k")]


def _at_depth(cfg, n):
    """``cfg`` at ``n`` periods; an encoder as deep as the decoder, as the
    reference's ``min(encoder_layers, n)`` is at the published depth."""
    return dataclasses.replace(cfg, n_layers=n * len(cfg.layer_pattern()),
                               encoder_layers=n if cfg.encoder_layers else 0)


@pytest.mark.parametrize("arch,shape", DEPTH_CELLS)
def test_full_depth_count_is_the_reference_extrapolation(arch, shape):
    base = reduced_config(get_config(arch), microbatch=2)

    def cost(n):
        return cells.analytic_cost(arch, shape, cfg=_at_depth(base, n),
                                   global_batch=4)

    f1, f2, f4 = cost(1), cost(2), cost(4)
    for key in ("flops", "bytes", "products", "elementwise"):
        assert f4[key] == f1[key] + (f2[key] - f1[key]) * 3, key


FORECAST_CELLS = [(a, s) for a in ("gemma2_2b", "mamba2_130m",
                                   "granite_moe_3b")
                  for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FORECAST_CELLS)
def test_meta_forecast_equals_a_cpu_run(arch, shape):
    """impl="torch", accum 4 (3 micro-batches counted): the peak, the
    memory split, FLOPs and bytes of the meta forecast equal the same
    counter's over a real CPU run, byte for byte."""
    cfg = reduced_config(get_config(arch), microbatch=2)
    got = {}
    for dev in ("meta", "cpu"):
        cell = cells.build_cell(arch, shape, make_local_mesh(dev), cfg=cfg,
                                global_batch=8, seq_len=256, impl="torch")
        got[dev] = cells.count_cell(cell)
    for key in ("peak_bytes", "argument_bytes", "output_bytes", "flops",
                "products", "elementwise", "transcendentals", "bytes",
                "ops", "result"):
        assert got["meta"][key] == got["cpu"][key], key
    assert got["cpu"]["peak_bytes"] > got["cpu"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch", ["granite_moe_3b", "jamba15_large_398b"])
def test_moe_and_hybrid_cells_run_on_meta(arch):
    cfg = reduced_config(get_config(arch))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for impl in ("torch", "cuda"):
            cell = cells.build_cell(arch, shape, META, cfg=cfg,
                                    global_batch=4, seq_len=256, impl=impl)
            got = cells.count_cell(cell)
            assert got["flops"] > 0 and got["peak_bytes"] > 0
            if shape != "train_4k" and impl == "cuda":
                # the kernel routes replace the attention (and the scan)
                assert got["kernel_launches"]["flash_" + (
                    "decode" if shape == "decode_32k" else "attention")] > 0
                assert got["kernel_flops"] > 0
            want = [4, 1, cfg.vocab] if shape != "train_4k" else []
            assert got["result"]["shape"] == want


def _old_dispatch(xl, ik, slot, keep, e, cap):
    """The boolean-indexed dispatch that the static one replaced."""
    nl, k = ik.shape
    tok = torch.arange(nl)[:, None].expand(nl, k)
    buf = xl.new_zeros(e, cap, xl.shape[1])
    buf[ik[keep], slot[keep]] = xl[tok[keep]]
    return buf


@pytest.mark.parametrize("tokens,skew", [(1, 0.0), (24, 0.0), (300, 0.0),
                                         (300, 4.0)])
def test_static_moe_dispatch_equals_boolean_indexing(tokens, skew,
                                                     monkeypatch):
    """``skew`` pulls the router to expert 0 (positive inputs, a raised
    router column), which then drops pairs."""
    cfg = reduced_config(get_config("granite_moe_3b"))
    gen = torch.Generator().manual_seed(tokens)
    p = {name: torch.randn(shape, generator=gen) * std
         for name, (shape, std) in mlp.moe_mlp_shapes(cfg).items()}
    p["router"][:, 0] += skew
    x = torch.randn(1, tokens, cfg.d_model, generator=gen)
    if skew:
        x = x.abs()
    seen = {}
    bmm = torch.bmm

    def recording_bmm(a, b):
        seen.setdefault("buf", a)
        return bmm(a, b)

    monkeypatch.setattr(torch, "bmm", recording_bmm)
    mlp.moe_mlp(p, x, cfg)
    xl = x.reshape(tokens, -1)
    _, ik, slot, keep = mlp._route(xl, p["router"], cfg)
    cap = mlp._capacity(tokens, cfg)
    want = _old_dispatch(xl, ik, slot, keep, cfg.n_experts, cap)
    assert torch.equal(seen["buf"], want)
    assert bool(keep.all()) == (skew == 0.0)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_gemma2_analytic_cost_against_reference(shape):
    check_against_reference("gemma2_2b", shape)
