"""The CUDA round-step kernel against its plain version, on the card.

Runs only where ``torch.cuda.is_available()`` (the check is made inside
the test): there ``repro_torch.kernels.round_step.chunk_step`` builds
``csrc/round_step.cu`` with nvcc and launches it, and after every chunk
its state must equal ``chunk_step_ref`` on the same CUDA tensors —
exactly, except the three time integrals (rtol 1e-5 float32, 1e-6
float64). ``python3 chip_smoke.py`` drives the same comparison at the
paper's full size.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import round_step as rsk
from repro_torch.sim import rounds, traces
from repro_torch.sim.sweep import ScanOptions, _pack_rounds, paper_grid

DAY = 24 * 3600.0
INTEGRALS = [rsk.SC_ACC0 + rounds.ACC_KEYS.index(k)
             for k in ("turn_sum", "exec_sum", "node_seconds")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_kernel_equals_plain_after_every_chunk_on_the_card(policy, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    horizon = 2 * DAY
    jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < horizon]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=128)
          if t < horizon]
    points = [p for p in paper_grid(128) if p.system == policy]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec, flb_spec) = _pack_rounds(
        points, [(jobs, ws)], horizon, opts, dev)
    grid, pk, spec = ((fb, fb_packs[0], fb_spec) if policy == "fb"
                      else (flb, flb_packs[0], flb_spec))
    prm = rounds._rounds_prm_tree(policy, grid, 1)
    ctx = rounds._lane_ctx(policy, prm, pk)
    sc, win = rounds._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    before = rsk.chunk_step.launches
    chunks = 0
    while bool((sc[:, rsk.SC_T] < horizon).any()):
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), chunks
        exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRALS]
        assert torch.equal(got[0][:, exact], want[0][:, exact]), chunks
        torch.testing.assert_close(
            got[0][:, INTEGRALS], want[0][:, INTEGRALS], atol=0,
            rtol=1e-5 if dtype == torch.float32 else 1e-6)
        live = sc[:, rsk.SC_T] < horizon
        sc = torch.where(live[:, None], want[0], sc)
        win = torch.where(live[:, None, None], want[1], win)
        chunks += 1
    assert rsk.chunk_step.launches - before == chunks > 20
