"""Serving launcher: the autoscaled WS TRE with batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \
        --requests 40 --ticks 200 [--reduced] [--device cpu]

The counterpart of ``repro.launch.serve``: drives the serving engine
with a synthetic Poisson request load and the §6.4 instance-adjustment
policy autoscaling replicas, and prints the paper's WS metrics
(throughput, average response time, instance trace). Like the
reference, ``--reduced`` is a ``store_true`` flag that defaults to True,
so the launcher always serves the reduced config. It runs on the CUDA
device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
from repro_torch.serving.autoscaler import AutoscaledService
from repro_torch.serving.engine import Request


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch)) if args.reduced \
        else get_config(args.arch)
    device = resolve_device(args.device)
    svc = AutoscaledService(cfg, device, slots_per_replica=4, max_len=64)
    rng = np.random.default_rng(args.seed)
    arrivals = np.sort(rng.uniform(0, args.ticks * 0.6,
                                   size=args.requests)).tolist()
    instance_trace = []
    rid = 0
    t0 = time.time()
    for tick in range(args.ticks):
        while arrivals and arrivals[0] <= tick:
            arrivals.pop(0)
            svc.submit(Request(
                rid=rid,
                prompt=rng.integers(0, cfg.vocab,
                                    size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new))
            rid += 1
        svc.tick(now=float(tick))
        instance_trace.append(len(svc.replicas))
        if not arrivals and not svc.queue and \
                all(r.n_active == 0 for r in svc.replicas):
            break
    wall = time.time() - t0
    lat = [r.completed - r.submitted for r in svc.completed if r.completed]
    result = {
        "completed": len(svc.completed),
        "throughput_tokens": sum(len(r.output or []) for r in svc.completed),
        "avg_response_s": float(np.mean(lat)) if lat else None,
        "max_instances": max(instance_trace),
        "final_instances": instance_trace[-1],
        "wall_s": round(wall, 2),
        "device": str(device),
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
