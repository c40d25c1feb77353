"""The dry run (``repro_torch.launch.dryrun``) and ``cells.analytic_cost``
against the JAX package's ``repro.launch.cells.analytic_cost`` at full
width.

The reference compiles each cell at 1 and 2 periods of layers on the CPU
and reads XLA's ``cost_analysis()["flops"]``. XLA's CPU backend computes
bfloat16 arithmetic in float32: it converts operands and results around
the products and elementwise ops (and, in decode, the whole KV cache
around its update and the attention), and its cost analysis charges 1
FLOP per converted element. Those conversions are not work the port
does. So each cell is held three ways (PERF.md, "the decode count"):

* the port's products equal the reference's ``dot`` FLOPs (1e-3);
* the port's count equals the reference's less its ``convert`` FLOPs,
  within 2 % (the converts are read off the reference's own compiled
  programs, extrapolated in depth as it extrapolates);
* ``train_4k`` and ``prefill_32k`` of gemma2-2b and granite-moe-3b
  within 2 % of the reference's count as it stands. For mamba2-130m
  (converts 4.1 % / 2.5 % of the reference's count) and every
  ``decode_32k`` (converts 65 % of gemma2's, 62 % of granite's, 2 % of
  mamba2's) the band is the second check.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.launch import cells, dryrun

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "xla_cost_parts", ROOT / "tools" / "xla_cost_parts.py")
xla_parts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(xla_parts)

AS_IS = {("gemma2_2b", "train_4k"), ("gemma2_2b", "prefill_32k"),
         ("granite_moe_3b", "train_4k"), ("granite_moe_3b", "prefill_32k")}


def check_against_reference(arch, shape):
    ref, parts = xla_parts.analytic_parts(arch, shape)
    got = cells.analytic_cost(arch, shape)
    dot = xla_parts.extrapolate(arch, shape, parts, "dot")
    convert = xla_parts.extrapolate(arch, shape, parts, "convert")
    assert got["products"] == pytest.approx(dot, rel=1e-3)
    assert got["flops"] == pytest.approx(ref["flops"] - convert, rel=0.02)
    if (arch, shape) in AS_IS:
        assert got["flops"] == pytest.approx(ref["flops"], rel=0.02)


# gemma2-2b's cells are held in test_torch_cells.py (the files run side by
# side).
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("mamba2_130m", "granite_moe_3b")
    for s in ("train_4k", "prefill_32k", "decode_32k")])
def test_analytic_cost_against_reference(arch, shape):
    check_against_reference(arch, shape)


def test_dryrun_writes_a_record_and_resumes(tmp_path, capsys):
    out = tmp_path / "results"
    argv = ["--arch", "mamba2_130m", "--shape", "long_500k",
            "--out", str(out)]
    dryrun.main(argv)
    path = out / "dryrun_card.json"
    (rec,) = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["fits_card"] is True
    assert rec["forecast"]["peak_bytes"] < 2 ** 30
    assert rec["forecast"]["kernel_launches"] == {}    # decode: no kernel
    for key in ("hlo_flops", "hlo_bytes", "t_compute_s", "t_memory_s",
                "bottleneck", "model_flops", "roofline_fraction",
                "mem_per_device_gb", "seconds"):
        assert key in rec, key
    assert set(rec["memory_analysis"]) == {
        "argument_size_gb", "output_size_gb", "temp_size_gb"}
    assert rec["t_collective_s"] == 0.0
    assert "ok" in capsys.readouterr().out
    # a rerun keeps the ok cell and counts nothing again
    mtime = path.stat().st_mtime_ns
    dryrun.main(argv)
    assert path.stat().st_mtime_ns == mtime


def test_dryrun_records_skips_and_refuses_pods(tmp_path):
    dryrun.main(["--arch", "gemma2_2b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    (rec,) = json.loads((tmp_path / "dryrun_card.json").read_text())
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    # The pod layouts run through the fake group, which is torn down.
    dryrun.main(["--multi-pod", "--arch", "gemma2_2b", "--shape",
                 "long_500k", "--out", str(tmp_path)])
    (rec,) = json.loads((tmp_path / "dryrun_multipod.json").read_text())
    assert rec["status"] == "skip" and rec["chips"] == 512
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_dryrun_workers_merge_and_resume(tmp_path, capsys):
    """``--workers``: one process per architecture, their records merged
    into the one file in the grid's order, the table printed; a rerun
    starts no process for an architecture whose cells are all ok."""
    argv = ["--workers", "4", "--shape", "long_500k", "--out",
            str(tmp_path)]
    recs = dryrun.main(argv)
    from repro_torch.configs.base import ARCH_IDS
    assert [r["arch"] for r in recs] == list(ARCH_IDS)
    ok = {r["arch"] for r in recs if r["status"] == "ok"}
    assert ok == {"jamba15_large_398b", "mamba2_130m"}
    assert all(r["status"] == "skip" for r in recs if r["arch"] not in ok)
    import torch
    assert all(r["torch"] == torch.__version__ for r in recs)
    assert json.loads((tmp_path / "dryrun_card.json").read_text()) == recs
    assert "| mamba2_130m | 0.3 / 0.00, memo |" in capsys.readouterr().out
    logs = {a: (tmp_path / "card_parts" / f"{a}.log").stat().st_mtime_ns
            for a in ok}
    again = dryrun.main(argv)
    assert [r["status"] for r in again] == [r["status"] for r in recs]
    for a, mtime in logs.items():
        assert (tmp_path / "card_parts" / f"{a}.log").stat() \
            .st_mtime_ns == mtime
