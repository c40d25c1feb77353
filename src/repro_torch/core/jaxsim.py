"""FLB-NUB tick simulator: the counterpart of ``repro.core.jaxsim``.

The §5.2 FLB-NUB dynamics over fixed-size arrays, so that the paper's
§6.6.4 parameter study (B × U × V × G, each point a full two-week trace)
runs as ONE program over every parameter lane: here one launch of the
CUDA kernel ``kernels/csrc/jaxsim.cu``, a block per lane, where the JAX
package runs one vmapped ``lax.scan``. Time advances in substeps of
``lease / SUBSTEPS`` (job completions round up to substep boundaries);
policy actions fire on lease-tick boundaries only, as in the event
simulator. Fidelity against the event engine: completed jobs within 2,
node-hours and peak within 15 % (``tests/test_torch_jaxsim.py``, the
reference's own band).

Entry points keep the reference's signatures and add keywords:

* ``device`` — ``None`` is the CUDA card (raises without one,
  ``compat.resolve_device``); ``"cpu"`` runs on the CPU.
* ``dtype`` — float32 by default, float64 on request
  (``compat.resolve_pack_dtype``). This replaces the reference's x64
  switch: there ``pack_trace`` follows the active x64 mode. The sweep's
  parameters are float32 whatever the dtype (as in the reference's
  ``sweep``), and a float64 run promotes them from their float32 values
  (G 0.99 runs as 0.99000000953…, as it does under x64).
* ``impl`` — ``"cuda"`` (the kernel, ``kernels.jaxsim_step.
  simulate_kernel``) or ``"torch"`` (the plain version,
  ``simulate_ref``); ``None`` picks ``"cuda"`` on a CUDA device and
  ``"torch"`` on the CPU. The plain version runs on a card only when
  asked for.

``simulate`` takes a batch of lanes at once (``FLBNUBParams`` of (L,)
tensors) where the reference's takes one lane and is vmapped; 0-d
parameters give 0-d outputs, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compat import (Device, resolve_backend, resolve_device,
                                resolve_pack_dtype)
from repro_torch.core.jobs import Job
from repro_torch.core.profiles import per_tick_profile
from repro_torch.kernels import jaxsim_step

__all__ = ["FLBNUBParams", "SUBSTEPS", "pack_trace", "simulate", "sweep"]


@dataclasses.dataclass(frozen=True)
class FLBNUBParams:
    """The §5.2 knobs, one entry per parameter lane: (L,) tensors."""

    B: torch.Tensor         # coordinated pool size (lower bounds sum)
    U: torch.Tensor         # threshold ratio of requesting
    V: torch.Tensor         # threshold ratio of releasing
    G: torch.Tensor         # elastic factor


SUBSTEPS = 12    # job dynamics advance at L/12 (300 s at L=1h); policy
#                  actions (provision / U-V-G adjust) fire on tick
#                  boundaries only, exactly like the event simulator.


def pack_trace(jobs: Sequence[Job], ws_trace: Sequence[Tuple[float, int]],
               duration: float, lease_seconds: float,
               substeps: int = SUBSTEPS, dtype=None, *,
               device: Device = None):
    """Fixed-size tensors on ``device``: the job table (submit, size,
    runtime) and the per-substep WS demand, with ``n_steps``."""
    dev = resolve_device(device)
    dtype = resolve_pack_dtype(dtype)
    dt = lease_seconds / substeps
    n_steps = int(np.ceil(duration / dt))
    submit = np.array([j.submit for j in jobs], dtype)
    size = np.array([j.size for j in jobs], dtype)
    runtime = np.array([j.runtime for j in jobs], dtype)
    ws = per_tick_profile(ws_trace, duration, dt)[:n_steps].astype(dtype)
    return (*(torch.as_tensor(a, device=dev)
              for a in (submit, size, runtime, ws)), n_steps)


def simulate(params: FLBNUBParams, submit, size, runtime, ws_demand,
             n_steps: int, lease_seconds: float, lb_ws: int = 12,
             substeps: int = SUBSTEPS, *, device: Device = None,
             dtype=None, impl: Optional[str] = None
             ) -> Dict[str, torch.Tensor]:
    """FLB-NUB runs of every lane of ``params`` over one packed trace.
    ``dtype`` ``None`` keeps the pack's; the parameters are cast to it."""
    dev = resolve_device(device)
    kind = resolve_backend(impl, dev)
    dt = submit.dtype if dtype is None else \
        getattr(torch, resolve_pack_dtype(dtype).name)
    table = [torch.as_tensor(x).to(dev, dt).contiguous()
             for x in (submit, size, runtime, ws_demand)]
    prm = torch.stack([torch.as_tensor(getattr(params, k)).to(dev)
                       for k in "BUVG"], -1)
    scalar = prm.dim() == 1
    prm = prm.reshape(-1, 4).to(dt).contiguous()
    run = jaxsim_step.simulate_kernel if kind == "cuda" \
        else jaxsim_step.simulate_ref
    out = run(prm, *table, n_steps=n_steps, lease_seconds=lease_seconds,
              lb_ws=lb_ws, substeps=substeps)
    return {k: v[0] for k, v in out.items()} if scalar else out


def sweep(param_grid: List[Dict[str, float]], jobs, ws_trace, duration,
          lease_seconds: float = 3600.0, lb_ws: int = 12,
          substeps: int = SUBSTEPS, *, device: Device = None, dtype=None,
          impl: Optional[str] = None) -> List[Dict]:
    """The §6.6.4 study: every point of ``param_grid`` as one lane of one
    run (one kernel launch on the card)."""
    dev = resolve_device(device)
    submit, size, runtime, ws, n_steps = pack_trace(
        jobs, ws_trace, duration, lease_seconds, substeps, dtype,
        device=dev)
    params = FLBNUBParams(**{
        k: torch.tensor([p[k] for p in param_grid], dtype=torch.float32,
                        device=dev) for k in "BUVG"})
    out = simulate(params, submit, size, runtime, ws, n_steps,
                   lease_seconds, lb_ws, substeps, device=dev, impl=impl)
    cols = {k: v.double().cpu().tolist() for k, v in out.items()}
    return [{**param_grid[i], **{k: v[i] for k, v in cols.items()}}
            for i in range(len(param_grid))]
