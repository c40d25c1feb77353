"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
        --steps 200 --batch 8 --seq-len 128 [--reduced] \
        [--checkpoint-dir DIR] [--device cpu]

The counterpart of ``repro.launch.train``, with its flags and its JSON
result (``completed``, ``step``, ``loss``, ``wall_seconds``,
``first_loss``). The reference picks a device mesh from the visible
devices; the port trains on one device: the CUDA device unless
``--device cpu`` is given. A job whose checkpoint directory holds a
checkpoint resumes from it.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
from repro_torch.train.trainer import TrainJob, TrainJobConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config of the arch")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={device}")
    job = TrainJob(cfg, TrainJobConfig(
        arch=args.arch, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, lr=args.lr, accum_steps=args.accum,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        data_path=args.data_path, seed=args.seed), device)
    result = job.run()
    first = job.history[0] if job.history else float("nan")
    out = {**result, "first_loss": first}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
