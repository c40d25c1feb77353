"""The controls of a cell's check, each one precision below what the
configuration states, compared as a run compares the program. Each has
to fail at least one of the cell's numbers; the benchmark's own runs
never run them. The cell's driver kind says what is one below:

* ``reference``: the plain reference in the program's place, computed
  one precision below (the driver's ``Driver.control``; ``mc_grid``: its
  lanes synthesized in bfloat16, one below the configuration's float32
  synthesis; ``tick_study``: its tick simulator in float32, one below
  the configuration's float64 pack): ``--queries`` is the window's query
  count. It runs on the card where there is one.
* ``program``: the program itself run as the driver's ``lower`` says
  (both kinds: its float32 pack, one below the configuration's float64
  pack), a window of ``--seconds`` on the card.

A parked cell (``harness/manifest.py``) is found too.

    python3 portbench/control.py --workload <cell> --control reference \\
        --seeds 1,2,3 --queries 41
    python3 portbench/control.py --workload <cell> --control program \\
        --seeds 1,2,3 --seconds 51

Prints one JSON line a seed: the numbers beside their limits."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.harness import compare, manifest  # noqa: E402


def control_checks(cell, seed: int, n_queries: int, device: str = "cpu"):
    """The ``reference`` control over what ``n_queries`` queries keep."""
    drv = cell.driver_module().Driver(cell.config, cell.traffic, seed,
                                      device)
    nums = drv.control(n_queries)
    return compare.checks(nums, cell.traffic["limits"],
                          cell.traffic["compared"])


def program_control_checks(cell, seed: int, seconds: float,
                           device: str = "cuda"):
    """The ``program`` control: a run of ``seconds`` of the program one
    precision below the configuration's (the driver's ``lower``)."""
    from portbench.smallcell import run_module
    cell.config, cell.traffic = cell.driver_module().lower(cell.config,
                                                           cell.traffic)
    _, checks, _ = run_module().run_cell(cell, seed, seconds, False,
                                         device=device)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=("reference", "program"),
                    required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        cell = manifest.Cell(manifest.with_parked(manifest.load_manifest()),
                             args.workload)
        if args.control == "reference":
            checks = control_checks(cell, int(s), args.queries, device)
        else:
            checks = program_control_checks(cell, int(s), args.seconds)
        print(json.dumps({"seed": int(s), "control": args.control,
                          "failed": not all(c["ok"] for c in checks),
                          "checks": {c["name"]: [str(c["value"]),
                                                 c["limit"]]
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
