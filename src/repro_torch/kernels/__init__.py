"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, for NVIDIA Hopper (``sm_90a``).

* ``round_step.py`` — the fused outer step of the event-rounds engine
  (``repro_torch.sim.rounds``), replacing the JAX package's Pallas
  ``repro.kernels.round_step.chunk_step``. Source:
  ``csrc/round_step.cu``. ``RoundsSpec.kernel`` picks the plain version
  (``chunk_step_ref``) on the CPU, and for packs with fault schedules on
  any device (the kernel has no fault stops).
* ``flash_attention.py`` — blocked online-softmax attention forward
  (GQA, causal, sliding window, softcap), replacing
  ``repro.kernels.flash_attention.flash_attention_bkv``. Source:
  ``csrc/flash_attention.cu``.
* ``flash_decode.py`` — one-token attention over a KV cache at a device
  scalar position (split-K over the cache, then a combine pass),
  replacing ``repro.kernels.flash_decode.flash_decode_bkv``. Source:
  ``csrc/flash_decode.cu``.
* ``ssd_scan.py`` — the Mamba2 SSD chunked scan (one launch per call:
  a block per chunk, its products on the tensor cores, the state handed
  from chunk to chunk by a chained scan), replacing
  ``repro.kernels.ssd_scan.ssd_scan_bh``. Source: ``csrc/ssd_scan.cu``.
* ``jaxsim_step.py`` — the §6.6.4 FLB-NUB tick simulator's whole run
  over parameter lanes in one launch, a block per lane
  (``simulate_kernel``; plain version ``simulate_ref``), used by
  ``repro_torch.core.jaxsim``. It has no Pallas counterpart: the JAX
  package runs ``repro.core.jaxsim.simulate`` as a vmapped ``lax.scan``.
  Source: ``csrc/jaxsim.cu``.
* ``ws_fold.py`` — the WS fold tables of a generated scenario batch
  (``fold_tables``; plain version ``fold_tables_ref``), built by
  ``repro_torch.sim.scenarios.pack_scenarios`` on the card straight into
  the pack dtype. It has no Pallas counterpart: it replaces the host's
  numpy ``repro.sim.rounds.ws_fold_tables_batch`` on that path. The
  wrapper runs the plain version on CPU tensors. Source:
  ``csrc/ws_fold.cu``.
* ``ref.py`` — the model kernels' plain versions; ``ops.py`` — the
  model-layout entry points the models call.

Every source is built with nvcc into ``build/`` at first use and bound
with ``ctypes`` (``cudalib.CudaLibrary``). A kernel wrapper takes CUDA
tensors and launches its kernel or raises; it counts its launches in
``<wrapper>.launches``.
"""
