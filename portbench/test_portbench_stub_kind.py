"""A second driver kind comes in as new files only. A copy of
``portbench/`` and ``BENCHMARK.json`` gains one cell of a stub kind,
``stub_tally``, with its own driver, faults, traffic, configuration,
metric readers and manifest entries, and no existing file changed. The
copy's own manifest, driver-kind, control and fault tests pass there;
without the stub's faults file, or its ``lower`` or ``small``, or with
its cell on four chips and no exchange to leave out, the driver-kind
test refuses it by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import manifest

KIND, CONFIG = "stub_tally", "stub_site"
CELL = f"{CONFIG}.{KIND}"

DRIVER = '''"""Each query sums ``lanes`` rows of ``steps`` uniform draws made from
the seed, with ``torch.cumsum`` in the traffic's ``dtype`` (the program).
The reference sums each row in float64 with a plain loop."""

import numpy as np
import torch

from portbench.harness import compare, seeds

LOWER = {"float64": "float32"}


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.traffic, self.seed, self.device = traffic, seed, device
        self.n_lanes, self.steps = int(traffic["lanes"]), int(config["steps"])
        self.dtype = getattr(torch, traffic["dtype"])
        self.kept = []

    def stages(self):
        return []

    def make(self, q):
        stream = seeds.WARMUP if q < 0 else seeds.WINDOW
        s = seeds.query_seeds(self.seed, stream, max(q, 0), 1)[0]
        return dict(q=q, x=np.random.default_rng(s).random(
            (self.n_lanes, self.steps)))

    def query(self, inp):
        x = torch.from_numpy(inp["x"]).to(self.device, self.dtype)
        return torch.cumsum(x, dim=1)[:, -1].double().cpu().numpy()

    def lanes(self, inp):
        return self.n_lanes

    def failed(self, out):
        return 0

    def before(self, inp):
        pass

    def keep(self, inp, out):
        if inp["q"] >= 0:
            self.kept.append((inp["x"], out))

    def work(self, inp):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def numbers(self, pairs):
        gap = 0.0
        for x, got in pairs:
            for row, g in zip(x, got):
                want = 0.0
                for v in row:
                    want += float(v)
                gap = max(gap, abs(float(g) - want) / abs(want))
        return {"total_gap": gap}

    def check(self):
        return compare.checks(self.numbers(self.kept),
                              self.traffic["limits"],
                              self.traffic["compared"])

    def control(self, n_queries):
        pairs = []
        for q in range(n_queries):
            x = self.make(q)["x"]
            pairs.append((x, np.cumsum(x.astype(np.float32), axis=1)[:, -1]))
        return self.numbers(pairs)


def lower(config, traffic):
    return config, dict(traffic, dtype=LOWER[traffic["dtype"]])


def small(config, traffic, days, lanes, points):
    return dict(config, steps=64), dict(traffic, lanes=lanes)
'''

FAULTS = '''import torch


def _step_unchanged(monkeypatch):
    monkeypatch.setattr(torch, "cumsum", lambda x, dim: x.clone())


def _half_left_out(monkeypatch):
    orig = torch.cumsum

    def half(x, dim):
        keep = torch.arange(x.shape[0]) % max(x.shape[0] // 2, 1)
        return orig(x, dim)[keep]

    monkeypatch.setattr(torch, "cumsum", half)


def _answer_altered(monkeypatch):
    orig = torch.cumsum
    monkeypatch.setattr(torch, "cumsum", lambda x, dim: orig(x, dim) + 1)


FAULTS = {"step_unchanged": _step_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
'''

SOURCE = "a stub deployment of the harness's own tests"
FILES = {
    f"drivers/{KIND}.py": DRIVER,
    f"faults/{KIND}.py": FAULTS,
    f"configs/{CONFIG}.json": json.dumps(
        {"name": CONFIG, "source": SOURCE, "steps": 4096,
         "precision": {"sum": "float64"}}),
    f"workloads/{CELL}.json": json.dumps(
        {"traffic": KIND, "driver": KIND, "lanes": 8, "dtype": "float64",
         "compared": ["total_gap"], "limits": {"total_gap": 1e-12}}),
    "metrics/stub_totals_per_s.py":
        "def read(run):\n"
        "    return run.lanes / run.window_s if run.window_s > 0 else None\n",
    "metrics/stub_query_ms.tally.py":
        "def read(run):\n"
        "    return 1e3 * sum(run.latencies) / len(run.latencies)\n",
}
ENTRIES = {
    "configs": {"name": CONFIG, "source": SOURCE,
                "file": f"portbench/configs/{CONFIG}.json",
                "reduced": ["steps"], "why": "a second driver kind"},
    "workloads": {"name": CELL, "config": CONFIG, "traffic": KIND,
                  "chips": 1, "why": "8 rows of 4096 draws summed a query"},
    "end_to_end": {"name": "stub_totals_per_s", "unit": "totals/s",
                   "better": "higher", "bound": 0.05, "source": "host_clock",
                   "workloads": [CELL]},
    "per_layer": {"name": "stub_query_ms.tally", "unit": "ms",
                  "better": "lower", "source": "host_clock",
                  "layer": "stub: torch.cumsum",
                  "moves": "stub_totals_per_s", "workloads": [CELL]},
}


def _copy_with_stub(tmp_path, chips=1, drop_file=None, drop_function=None):
    """The benchmark's files and the stub's new ones under ``tmp_path``."""
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(
                        "__pycache__", "test_portbench_stub_kind.py"))
    for rel, text in FILES.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), f"{rel} is not a new file"
        if drop_function:
            text = text.replace(f"def {drop_function}(",
                                f"def _{drop_function}(")
        if rel != drop_file:
            path.write_text(text)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entry in ENTRIES.items():
        man[key].append(dict(entry, chips=chips) if key == "workloads"
                        else entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


def _pytest(tmp_path, files, expr):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(manifest.ROOT / "src")]))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "no:randomly", *[f"portbench/{f}" for f in files],
         "-k", expr], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)


def test_stub_kind_passes_the_copys_checks(tmp_path):
    _copy_with_stub(tmp_path)
    out = _pytest(tmp_path, ["test_portbench_manifest.py",
                             "test_portbench_drivers.py",
                             "test_portbench_control.py",
                             "test_portbench_reference.py"],
                  "stub or portbench_manifest or portbench_drivers")
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    for case in (f"test_driver_kind_plants_its_faults[{KIND}]",
                 f"test_driver_kind_defines_its_functions[{KIND}]",
                 f"test_lower_and_small_return_new_pairs[{CELL}]",
                 f"test_cell_files_found_by_name[{CELL}]",
                 f"test_config_entry[{CONFIG}]",
                 f"test_control_fails[{CELL}]",
                 f"test_program_control_fails[{CELL}]",
                 f"test_fault_is_caught[{CELL}-step_unchanged]",
                 f"test_fault_is_caught[{CELL}-half_left_out]",
                 f"test_fault_is_caught[{CELL}-answer_altered]",
                 f"test_cell_is_correct_on_the_cpu[{CELL}]"):
        assert f"{case} PASSED" in out.stdout, case


@pytest.mark.parametrize("missing,message", [
    ("faults", f"faults/{KIND}.py is missing"),
    ("lower", f"drivers/{KIND}.py defines no ['lower']"),
    ("small", f"drivers/{KIND}.py defines no ['small']"),
    ("exchange", f"faults/{KIND}.py plants no ['exchange_left_out']")],
    ids=["faults", "lower", "small", "exchange"])
def test_stub_kind_is_refused_by_name(tmp_path, missing, message):
    _copy_with_stub(
        tmp_path, chips=4 if missing == "exchange" else 1,
        drop_file=f"faults/{KIND}.py" if missing == "faults" else None,
        drop_function=missing if missing in ("lower", "small") else None)
    out = _pytest(tmp_path, ["test_portbench_manifest.py",
                             "test_portbench_drivers.py"],
                  "stub or portbench_manifest")
    assert out.returncode != 0
    assert message in out.stdout, out.stdout[-4000:]
    failed = [line for line in out.stdout.splitlines()
              if line.startswith("FAILED ")]
    assert failed and all("portbench_drivers.py" in line
                          for line in failed), failed
