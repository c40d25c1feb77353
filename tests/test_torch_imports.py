"""The port stands alone, and its copies equal the JAX package's modules.

* ``repro_torch`` (and ``chip_smoke.py``) import neither ``jax`` nor any
  module of ``repro``: checked in a fresh interpreter.
* The copied modules are the reference's byte for byte except
  ``repro.`` → ``repro_torch.`` in their import lines and the named
  ``SUBSTITUTIONS`` (in ``configs/base.py``, the one module path
  ``get_config`` imports by name; in ``train/data.py``, its two unused
  JAX imports dropped), and the copies give the reference's traces,
  contract table and configs.
* ``compat.resolve_device`` never falls back to the CPU by itself, and
  takes the meta device only when asked for it.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import base as ref_base
from repro.sim import contracts as ref_contracts
from repro.sim import traces as ref_traces
from repro_torch import compat
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.sim import contracts, traces

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["core/jobs.py", "core/profiles.py", "core/cluster.py",
          "core/pbj_manager.py", "core/ws_manager.py", "core/system.py",
          "core/provision.py", "core/baselines.py", "sim/pump.py",
          "sim/engine.py", "sim/traces.py", "sim/contracts.py",
          "sim/__init__.py", "core/__init__.py", "serving/autoscaler.py",
          "configs/__init__.py", "configs/base.py", "sim/faults.py",
          "core/spec.py", "core/lifecycle.py", "core/runtime_bridge.py",
          "serving/replay.py", "train/data.py"] + [
    f"configs/{arch}.py" for arch in ARCH_IDS]
# The substitutions outside import lines: get_config imports the arch
# module by a string name, which must name the port's copy; the data
# pipeline's two JAX imports, which it never uses, are dropped.
SUBSTITUTIONS = {"configs/base.py": [(
    'importlib.import_module(f"repro.configs.{arch}")',
    'importlib.import_module(f"repro_torch.configs.{arch}")')],
    "train/data.py": [("import jax\nimport jax.numpy as jnp\n", "")]}

_HYGIENE = """
import sys
{body}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("clean")
"""


def _run_clean(body):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _HYGIENE.format(body=body)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_port_imports_no_jax_and_no_reference():
    _run_clean("import repro_torch.sim.capacity, "
               "repro_torch.kernels.round_step, repro_torch.sim.sweep, "
               "repro_torch.sim.rounds, repro_torch.compat, "
               "repro_torch.serving.autoscaler, "
               "repro_torch.models.transformer, repro_torch.kernels.ops, "
               "repro_torch.models.mamba2, repro_torch.kernels.ssd_scan, "
               "repro_torch.launch.serve, repro_torch.sim.faults, "
               "repro_torch.core.runtime_bridge, "
               "repro_torch.serving.replay, repro_torch.sim.scenarios, "
               "repro_torch.train.trainer, repro_torch.launch.train, "
               "repro_torch.launch.mesh, repro_torch.launch.cells, "
               "repro_torch.launch.hlo_analysis, "
               "repro_torch.launch.dryrun; "
               "from repro_torch.configs import all_configs; all_configs()")


def test_chip_smoke_imports_no_jax_and_no_reference():
    _run_clean("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='chip_smoke')")


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_the_reference_with_imports_switched(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    switched = re.sub(r"^(\s*)from repro(\.| import)", r"\1from repro_torch\2",
                      ref, flags=re.M)
    for old, new in SUBSTITUTIONS.get(rel, []):
        assert switched.count(old) == 1, old
        switched = switched.replace(old, new)
    assert port == switched


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_copied_configs_equal_reference(arch):
    got = get_config(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(ref_base.get_config(arch))


@pytest.mark.parametrize("name,args", [("nasa_ipsc", (0,)),
                                       ("sdsc_blue", (0,)),
                                       ("worldcup98", (0, 128))])
def test_copied_traces_equal_reference(name, args):
    ref = getattr(ref_traces, name)(*args)
    got = getattr(traces, name)(*args)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        if isinstance(a, tuple):
            assert a == b
        else:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_contract_table_equals_reference():
    assert set(contracts.CONTRACTS) == set(ref_contracts.CONTRACTS)
    for k, v in ref_contracts.CONTRACTS.items():
        assert dataclasses.asdict(contracts.CONTRACTS[k]) == \
            dataclasses.asdict(v), k


def test_resolve_device_has_no_silent_cpu_fallback():
    assert compat.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert compat.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            compat.resolve_device()
        with pytest.raises(RuntimeError, match="not available"):
            compat.resolve_device("cuda")
    assert compat.resolve_devices(None) is None
    assert compat.resolve_devices(1) is None
    assert compat.resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA device\\(s\\) visible"):
            compat.resolve_devices(2)
    import numpy as np
    assert compat.resolve_pack_dtype(None) == np.float32
    assert compat.resolve_pack_dtype(torch.float64) == np.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        compat.resolve_pack_dtype(np.int32)


def test_meta_is_taken_on_request_only():
    """``None`` still means the card (no fallback to the CPU or to meta);
    ``"meta"`` is the dry run's explicit request, and a model there runs
    what the card would, the kernels' routes."""
    assert compat.resolve_device("meta") == torch.device("meta")
    assert compat.resolve_backend(None, torch.device("meta")) == "cuda"
    assert compat.resolve_backend("torch", torch.device("meta")) == "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            compat.resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        compat.resolve_device("xpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        compat.resolve_backend("cuda", torch.device("cpu"))
