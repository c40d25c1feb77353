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
16 chips). The default here is one H100 (``dryrun_card.json``);
``--layout pod`` takes the reference's 16 × 16 layout of 256 cards
(``dryrun_singlepod.json``) and ``--multi-pod`` its 2 × 16 × 16 of 512
(``dryrun_multipod.json``). A pod layout runs in one process through
PyTorch's ``fake`` process group on the meta device: one rank stands
for every rank, weights, optimizer state, cache and batch are DTensors
placed by the sharding specs, and the counters see that rank's local
program. Each cell then records per-card FLOPs, bytes and forecast
peak, and the collective bytes by kind with the link time (NVLink 4
within an 8-card node, the network across nodes; ``hlo_analysis``).

``--workers N`` runs the architectures in ``N`` processes of this
module at once (each with its own ``fake`` group), merges their records
into the one file and prints each shape's per-card forecast peak, the
per-card collective bytes and the bottleneck, one row per architecture.

Usage (on the CPU: nothing is allocated and nothing needs a card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--layout card|pod] [--multi-pod] [--arch gemma2_2b] \\
        [--shape train_4k] [--out results/] [--workers 8]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.cells import analytic_cost, build_cell, count_cell
from repro_torch.launch.mesh import (Layout, make_local_mesh,
                                     make_production_mesh)

__all__ = ["SHAPES", "run_cell", "main"]

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_cell(arch: str, shape_name: str, layout: Layout,
             chips: int = 1) -> dict:
    cfg = get_config(arch)
    shape = cfg.shapes()[shape_name]
    # DTensor's choice of collectives (and so a pod cell's collective
    # bytes) changes between PyTorch releases: each record names its own.
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "chips": chips, "torch": torch.__version__, "status": None}
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
        rec["collectives"] = counted["collectives"]
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2 x 16 x 16 layout (512 cards)")
    ap.add_argument("--layout", choices=("card", "pod"), default="card",
                    help="one H100, or the reference's 16 x 16 pod")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results")
    ap.add_argument("--workers", type=int, default=1,
                    help="architectures run at once, one process each")
    args = ap.parse_args(argv)
    if args.workers > 1 and not args.arch:
        return _parallel(args)
    if args.multi_pod or args.layout == "pod":
        with _fake_group(512 if args.multi_pod else 256):
            layout = make_production_mesh(multi_pod=args.multi_pod)
            return _grid(args, layout, _tag(args))
    return _grid(args, make_local_mesh("meta"), "card")


@contextlib.contextmanager
def _fake_group(world: int):
    """PyTorch's ``fake`` process group of ``world`` ranks in this
    process (rank 0 stands for all), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tag(args) -> str:
    return "multipod" if args.multi_pod else \
        "singlepod" if args.layout == "pod" else "card"


def _parallel(args) -> list:
    """Every architecture in its own process of this module, ``workers``
    at a time, each writing under ``<out>/<tag>_parts/<arch>``; the
    records merged into ``<out>/dryrun_<tag>.json`` (cells already ``ok``
    there are kept, as a rerun resumes) and the per-card table
    printed."""
    tag = _tag(args)
    path = os.path.join(args.out, f"dryrun_{tag}.json")
    parts = os.path.join(args.out, f"{tag}_parts")
    os.makedirs(parts, exist_ok=True)
    done = []
    if os.path.exists(path):
        with open(path) as f:
            done = [r for r in json.load(f) if r["status"] == "ok"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    todo = [a for a in ARCH_IDS
            if sum(r["arch"] == a for r in done) < len(shapes)]
    flags = ["--multi-pod"] if args.multi_pod else ["--layout", args.layout]
    flags += ["--shape", args.shape] if args.shape else []
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))

    def run(arch):
        out = os.path.join(parts, arch)
        with open(out + ".log", "w") as log:
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *flags, "--arch", arch, "--out", out],
                           stdout=log, stderr=subprocess.STDOUT, env=env,
                           check=False)

    t0 = time.time()
    with ThreadPoolExecutor(args.workers) as pool:
        list(pool.map(run, todo))
    results = [r for r in done if r["arch"] not in todo]
    for arch in todo:
        part = os.path.join(parts, arch, f"dryrun_{tag}.json")
        if os.path.exists(part):
            with open(part) as f:
                results += json.load(f)
        else:
            results += [{"arch": arch, "shape": sh, "status": "fail",
                         "error": "no record"} for sh in shapes]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    results.sort(key=lambda r: (order[r["arch"]], SHAPES.index(r["shape"])))
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    by = {(r["arch"], r["shape"]): r for r in results}
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for arch in ARCH_IDS:
        print(f"| {arch} | " + " | ".join(
            _cell_text(by.get((arch, sh))) for sh in shapes) + " |")
    _summary(results, tag, path)
    print(f"[{tag}] wall {time.time() - t0:.1f} s, {args.workers} workers")
    return results


def _cell_text(rec: Optional[dict]) -> str:
    """A table cell: forecast peak GiB / collective GiB, bottleneck."""
    if rec is None or rec["status"] == "fail":
        return "FAIL"
    if rec["status"] == "skip":
        return "skip"
    gib = 2 ** 30
    return (f"{rec['forecast']['peak_bytes'] / gib:.1f} / "
            f"{rec['coll_bytes'] / gib:.2f}, {rec['bottleneck'][:4]}")


def _summary(results: list, tag: str, path: str) -> None:
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"[{tag}] done: {ok} ok / {skip} skip / {fail} fail → {path}")


def _grid(args, layout: Layout, tag: str) -> list:
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
                         f"{rec['coll_bytes'] / 2**30:8.2f} GiB coll "
                         f"{rec['bottleneck']:8s} fits {rec['fits_card']}")
            print(f"[{tag}] {arch:22s} {shape:12s} {status:5s} "
                  f"{rec['seconds']:7.1f}s  {extra[:80]}", flush=True)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)

    _summary(results, tag, path)
    return results


if __name__ == "__main__":
    main()
