"""On the card: one short run of each cell through the command, its
result line and the check. Skips where no CUDA card is present."""

import json
import subprocess
import sys

import pytest

from portbench.harness import manifest

CELLS = manifest.cell_names(manifest.load_manifest())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    cell = manifest.Cell(manifest.load_manifest(), name)
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cell.chips
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
