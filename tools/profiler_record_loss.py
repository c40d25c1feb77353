"""Which device records a ``torch.profiler`` trace loses as its process ages.

Usage (one CUDA card): ``PYTHONPATH=src python3 tools/profiler_record_loss.py``

At each check, every ``--every`` seconds of matmul load, it prints one JSON
line: an unmarked trace of ``--ticks`` small kernels, sent at uneven gaps,
and how many of their records it lost at its head and at its tail (the kept
records' start gaps are fitted to the sent gaps), with the kept records'
start less their host send time; then ``chip_smoke.marked_profile`` around
3 such kernels: the marks it lost and the kernels it kept.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def unmarked(x, gaps):
    """Kernel starts kept by a plain trace of one ``add_`` per gap, and
    the host send times, both in ns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sent = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for g in gaps:
            sent.append(time.time_ns())
            x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(g)
    got = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and "elementwise" in e.name())
    return np.array(sent, np.int64), np.array(got, np.int64)


def check(x, rng, ticks):
    sent, got = unmarked(x, rng.uniform(0.5e-3, 6e-3, ticks))
    lost = len(sent) - len(got)
    fits = [np.abs(np.diff(got) - np.diff(sent[k:k + len(got)])).max()
            for k in range(lost + 1)]
    head = int(np.argmin(fits))
    off = (got - sent[head:head + len(got)]) / 1e6
    with cs.marked_profile() as prof:
        for _ in range(3):
            x.add_(1.0)
    events, marks_lost = cs.device_kernels(prof)
    return dict(ticks=ticks, lost_head=head, lost_tail=lost - head,
                gap_fit_us=float(fits[head]) / 1e3,
                kept_start_less_send_ms=[float(off.min()), float(off.max())],
                marked_marks_lost=marks_lost,
                marked_kept=sum(e.count for e in events
                                if "elementwise" in e.key))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks", type=int, default=7)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--ticks", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    x = torch.zeros(1 << 20, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    rng = np.random.default_rng(0)
    born = time.time()
    for _ in range(args.checks):
        print(json.dumps(dict(age_s=time.time() - born,
                              **check(x, rng, args.ticks))), flush=True)
        t = time.time()
        while time.time() - t < args.every:
            a @ a
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
