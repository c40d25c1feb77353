"""The dry run: the counterpart of ``repro.launch.dryrun``.

Builds every (architecture × input shape) cell at its published width,
depth and global batch on the meta device (no allocation) for one H100,
and records per cell: its FLOPs and bytes, the forecast peak memory on
the card with the reference's ``memory_analysis`` split, whether it fits
the card (``fits_card``), and the roofline terms with the H100's
constants (``hlo_analysis``). Results go to ``<out>/dryrun_card.json``;
a rerun resumes from that file (cells already ``ok`` are kept).

Per cell, two counting passes: the forecast (``cells.count_cell``) runs
the cell as the card would, kernels included (their meta routes report
each kernel's work), and ``cells.analytic_cost`` counts the reference's
semantics (the plain path, dense global attention) for the roofline
row, as the reference's analytic path overrides XLA's per-device counts.

The reference lowers against its TPU pod meshes (16 × 16 and 2 × 16 ×
16 chips). The port runs the one-card layout only: per-card memory and
collective bytes under a pod layout need the parameter, cache and batch
sharding specs (the reference's ``param_specs``, ``cache_pspecs`` and
``batch_pspecs``), which the port does not have yet (ROADMAP A3), so
``--multi-pod`` raises ``NotImplementedError``.

Usage (on the CPU: nothing is allocated and nothing needs a card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch gemma2_2b] [--shape train_4k] [--out results/]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Sequence

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.cells import analytic_cost, build_cell, count_cell
from repro_torch.launch.mesh import Layout, make_local_mesh

__all__ = ["SHAPES", "run_cell", "main"]

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_cell(arch: str, shape_name: str, layout: Layout,
             chips: int = 1) -> dict:
    cfg = get_config(arch)
    shape = cfg.shapes()[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "chips": chips, "status": None}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, layout)
        if cell.skip:
            rec["status"] = "skip"
            rec["reason"] = cell.skip
            rec["seconds"] = round(time.time() - t0, 1)
            return rec
        counted = count_cell(cell)
        ana = analytic_cost(arch, shape_name)
        roof = hlo_analysis.analyze(
            arch, shape_name, counted, chips,
            model_flops=hlo_analysis.model_flops_estimate(cfg, shape),
            flops_override=ana.get("flops"),
            bytes_override=ana.get("bytes"))
        rec.update(roof.row())
        rec["analytic"] = ana
        rec["forecast"] = {k: v for k, v in counted.items()
                           if k != "memory_analysis"}
        rec["memory_analysis"] = counted["memory_analysis"]
        rec["fits_card"] = counted["peak_bytes"] <= \
            hlo_analysis.CARD_MEMORY_BYTES
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the dry run runs the one-card layout; pod "
            "layouts need the sharding specs (ROADMAP A3)")

    layout = make_local_mesh("meta")
    tag = "card"
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"dryrun_{tag}.json")
    results = []
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results if r["status"] == "ok"}

    for arch in archs:
        for shape in shapes:
            if (arch, shape) in done:
                continue
            rec = run_cell(arch, shape, layout, layout.size)
            results = [r for r in results
                       if not (r["arch"] == arch and r["shape"] == shape)]
            results.append(rec)
            status = rec["status"]
            extra = rec.get("reason", rec.get("error", ""))
            if status == "ok":
                extra = (f"{rec['hlo_flops']:.3e} FLOP  "
                         f"{rec['forecast']['peak_bytes'] / 2**30:9.1f} GiB "
                         f"{rec['bottleneck']:8s} fits {rec['fits_card']}")
            print(f"[{tag}] {arch:22s} {shape:12s} {status:5s} "
                  f"{rec['seconds']:7.1f}s  {extra[:80]}", flush=True)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)

    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"[{tag}] done: {ok} ok / {skip} skip / {fail} fail → {path}")
    return results


if __name__ == "__main__":
    main()
