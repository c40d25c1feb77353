"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, for NVIDIA Hopper (``sm_90a``).

* ``round_step.py`` — the fused outer step of the event-rounds engine
  (``repro_torch.sim.rounds``), replacing the JAX package's Pallas
  ``repro.kernels.round_step.chunk_step``. Source:
  ``csrc/round_step.cu``, built with nvcc into ``build/`` at first use
  and bound with ``ctypes``. The wrapper takes CUDA tensors and
  launches the kernel or raises; ``RoundsSpec.kernel`` picks the plain
  version (``chunk_step_ref``) on the CPU.

The JAX package's other three Pallas kernels (flash attention, flash
decode, SSD scan) serve the LM payload models and are not ported yet.
"""
