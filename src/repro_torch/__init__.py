"""PhoenixCloud's §6 provisioning evaluation in PyTorch, for NVIDIA GPUs.

The counterpart of the JAX package ``repro``, module for module:

  repro_torch.core     — the paper's systems (FB, FLB-NUB, DCS, EC2), the
                         event engine's building blocks (numpy only) and
                         the live tier's ``LiveCloud`` (runtime_bridge)
  repro_torch.sim      — traces, the event engine, the event-rounds
                         engine (with the chaos tier's fault stops,
                         ``faults.py``), the fixed-dt scan engine,
                         generated scenario batches (``scenarios.py``),
                         the sweep and the capacity queries
  repro_torch.configs  — the architecture configs (copied)
  repro_torch.models   — dense decoder LMs (gemma2, smollm, qwen) and
                         Mamba2 SSMs: prefill and decode over KV / SSM
                         caches
  repro_torch.serving  — the continuous-batching engine, the §6.4
                         autoscaler and trace replay through it (the
                         live tier, ``replay.py``)
  repro_torch.launch   — the serving CLI
  repro_torch.kernels  — hand-written CUDA kernels (``round_step``,
                         ``flash_attention``, ``flash_decode``,
                         ``ssd_scan``) with their plain PyTorch versions

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that explicit choice they raise.
"""

__version__ = "0.1.0"
