"""PhoenixCloud's §6 provisioning evaluation in PyTorch, for NVIDIA GPUs.

The counterpart of the JAX package ``repro``, module for module:

  repro_torch.core     — the paper's systems (FB, FLB-NUB, DCS, EC2), the
                         event engine's building blocks (numpy only)
  repro_torch.sim      — traces, the event engine, the event-rounds
                         engine, the sweep and the capacity queries
  repro_torch.kernels  — hand-written CUDA kernels (``round_step``) with
                         their plain PyTorch versions

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that explicit choice they raise.
"""

__version__ = "0.1.0"
