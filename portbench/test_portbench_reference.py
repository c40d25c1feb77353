"""The plain reference against the program on the CPU at a two-day
horizon, and the check that nothing of the JAX package is loaded."""

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import guard, manifest
from portbench.smallcell import run_module, run_small, small_cell

CELLS = manifest.cell_names(manifest.with_parked(manifest.load_manifest()))
LIVE = manifest.cell_names(manifest.load_manifest())


def test_reference_lanes_equal_the_programs_synthesis():
    from repro_torch.sim import scenarios as sc
    cell = small_cell("ipsc_wc98.mc_fb")
    drv = cell.driver_module().Driver(cell.config, cell.traffic,
                                      2 ** 33 + 1, "cpu")
    grid = drv.make(0)["grid"]
    batch = sc.synthesize(grid, "cpu")
    for w, s in enumerate(grid.seeds):
        lane = drv.lane(s)
        for k in ("submit", "size", "runtime", "ws_values"):
            np.testing.assert_array_equal(lane[k], getattr(batch, k)[w])
        assert lane["n_jobs"] == batch.n_jobs[w]


def test_reference_rows_in_worker_processes_equal_the_serial_rows():
    from portbench.harness import refpool
    cell = small_cell("ipsc_wc98.mc_fb", days=1.0)
    drv = cell.driver_module().Driver(cell.config, cell.traffic, 5, "cpu")
    tasks = [(s, drv.site, drv.points[:2], "float32", drv.lane(s))
             for s in drv.make(0)["seeds"][:2]]
    serial = refpool.rows_of(tasks, 1)
    assert refpool.rows_of(tasks, 2) == serial
    assert [len(rows) for _, rows in serial] == [2, 2]
    assert all(nums["tables_ws"] == 0 for nums, _ in serial)


def test_a_lane_synthesized_otherwise_is_judged_by_its_tables():
    from portbench.harness import refpool
    cell = small_cell("ipsc_wc98.mc_fb", days=1.0)
    drv = cell.driver_module().Driver(cell.config, cell.traffic, 6, "cpu")
    s = drv.make(0)["seeds"][0]
    got = drv.lane(s)
    got["ws_values"] = got["ws_values"].copy()
    got["ws_values"][7] += 1
    nums, rows = refpool.judged_lane((s, drv.site, drv.points, "float32",
                                      got))
    assert rows is None and 0 < nums["tables_ws"] < 0.01


def test_window_reads_the_hosts_seconds():
    host = run_module().host_seconds()
    assert host["cpu_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name):
    result, checks = run_small(small_cell(name))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(small_cell(name).traffic["compared"])


def test_traced_cpu_run_reads_the_stages():
    result, _ = run_small(small_cell("ipsc_wc98.mc_fb"), trace=True)
    m = result["metrics"]
    assert m["synth_ms.mc"]["value"] > 0 and m["pack_ms.mc"]["value"] > 0
    # No card, no device trace: its metrics are left out, not zero.
    assert "round_step_roofline.mc" not in m


def test_forbidden_names_compare_whole_top_level_names():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.sim",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["repro.sim.rounds", "jax.numpy",
                                   "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_harness_and_reference_load_nothing_of_jax():
    code = (
        "import sys; sys.path[:0] = ['src', '.'];"
        "import portbench.harness.manifest as m, portbench.reference.rows,"
        " portbench.harness.refpool, portbench.reference.scenarios;"
        "import portbench.harness.trace, portbench.harness.stages;"
        "ref = {n.split('.')[0] for n in sys.modules};"
        "M = m.with_parked(m.load_manifest());"
        "cs = [m.Cell(M, n) for n in m.cell_names(M)];"
        "[c.driver_module() for c in cs];"
        "[m.metric_readers(c.per_layer + c.end_to_end) for c in cs];"
        "from portbench.harness.guard import forbidden_loaded;"
        "print(sorted(ref & {'repro_torch', 'repro', 'jax', 'jaxlib',"
        " 'flax'}), forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "[]"]


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         LIVE[0], "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         LIVE[0], "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_tick_reference_equals_the_programs_plain_step():
    """``reference/ticksim.py`` over a table per lane, one of them padded
    (the second fortnight cut by five jobs), gives the program's plain
    step's rows bit for bit, in float64 and float32."""
    import torch
    from portbench.reference import ticksim
    from repro_torch.kernels import jaxsim_step
    cell = small_cell("ipsc_wc98.mc_study", days=1.0, lanes=2)
    drv = cell.driver_module().Driver(cell.config, cell.traffic, 2 ** 31 + 9,
                                      "cpu")
    batch = drv.sc.synthesize(drv.make(0)["grid"], device="cpu")
    prm = torch.tensor([[p[k] for k in "BUVG"] for p in drv.points])
    n_jobs = [int(batch.n_jobs[0]), int(batch.n_jobs[1]) - 5]
    for dtype in (torch.float64, torch.float32):
        items = [(dict(submit=batch.submit[w], size=batch.size[w],
                       runtime=batch.runtime[w], n_jobs=n_jobs[w],
                       ws_values=batch.ws_values[w]), i)
                 for w in range(2) for i in range(len(drv.points))]
        ref = drv.reference_rows(items, dtype)
        for w in range(2):
            n = n_jobs[w]
            got = jaxsim_step.simulate_ref(
                prm.to(dtype), *(torch.from_numpy(a[w, :n]).to(dtype) for a
                                 in (batch.submit, batch.size,
                                     batch.runtime)),
                torch.from_numpy(batch.ws_values[w, :drv.n_steps]).to(dtype),
                n_steps=drv.n_steps, lease_seconds=drv.lease,
                lb_ws=drv.lb_ws, substeps=drv.substeps)
            for i in range(len(drv.points)):
                want = ref[w * len(drv.points) + i]
                assert {k: float(got[k][i]) for k in ticksim.OUTPUTS} \
                    == want, (dtype, w, i)


def test_traced_cpu_run_of_the_study_reads_its_stages():
    result, _ = run_small(small_cell("ipsc_wc98.mc_study", days=1.0),
                          trace=True)
    assert result["correct"] is True, result
    m = result["metrics"]
    assert m["synth_ms.study"]["value"] > 0
    assert m["simulate_ms.study"]["value"] > 0
    assert "jaxsim_us_per_lane.study" not in m
