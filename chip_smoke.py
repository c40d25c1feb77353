"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits nonzero):

  device           the card's name and power limit (nvidia-smi)
  build            nvcc builds of the five kernels for sm_90a
                   (round_step, flash_attention, flash_decode, ssd_scan,
                   jaxsim), started together
  kernel_vs_plain  the FB and FLB-NUB lanes of paper_grid(128), packed
                   exactly as the sweep packs them (one pack per trace:
                   NASA iPSC and SDSC BLUE, each with WorldCup): the CUDA
                   round step against its plain PyTorch version from the
                   same state after EVERY chunk, float32 over two weeks
                   and float64 over a two-day slice; exact except the
                   three time integrals. First with coalescing off (batch
                   1), then with the contended-stretch coalescer on
                   (batch 8), where every pack must coalesce. Then the
                   engine's one-launch run of the same lanes
                   (round_step.run_rounds) against the per-chunk kernel
                   path: final states equal bit for bit, integrals too,
                   and each lane's outer steps equal. Each line carries
                   the one-step kernel's (CUDA events, calls queued
                   behind a spin) and the plain version's times at the
                   middle chunk, its bound and serial-chain time, and the
                   run's device time, bound and plain host-loop time
  sweep            run_sweep_workloads over paper_grid(128) on both
                   traces (two weeks, mode="rounds") through the kernel:
                   one launch per trace and policy, whose outer steps
                   equal the chunk-by-chunk check's; rows equal the plain
                   version's on the card; the NASA FB / FLB-NUB rows
                   inside CONTRACTS["rounds"] against the event engine;
                   the wall split into pack, startup and kernel (a call
                   of its own, each stage synchronized)
  sweep_coalesced  the same sweep with ScanOptions(coalesce=8) through
                   the kernel: launches and outer steps as the coalesced
                   chunk-by-chunk check's, completed jobs equal the
                   uncoalesced rows', the NASA rows inside
                   CONTRACTS["rounds"] against the same event rows;
                   launches, outer steps, max rounds, wall and its split
                   beside the uncoalesced sweep's (both walls timed again
                   after, in the other order)
  headline         headline_queries() on the card: C = 135, DCS 256,
                   FLB-NUB peak 660, EC2 peak 1075
                   (results/BENCH_capacity.json) and the
                   HEADLINE_CONTRACT gate; launches, outer steps and the
                   wall's split
  headline_coalesced
                   the same queries with ScanOptions(coalesce=8): the
                   same four answers and gate, its wall beside headline's
  sharded          the multi-device paths one card can run: (a) the
                   sweep (paper_grid(128), both traces, two weeks,
                   mode="rounds"), plain and coalesced, with
                   devices=["cuda:0", "cuda:0"]: rows equal to
                   devices=None's bit for bit, one round_step launch per
                   shard, trace and policy (8), the lanes each policy
                   pads; (b) headline_queries with the same list: 135 /
                   256 / 660 / 1075; (c) devices=<visible + 1> raises
                   ValueError naming the visible count, a fault pack with
                   devices raises NotImplementedError; (d) a one-rank
                   nccl group: reduced gemma2-2b and granite-moe-3b
                   TrainJobs on a (1, 1) make_mesh layout (DTensor
                   weights) for 3 steps, losses equal to the plain
                   one-device job's bit for bit; (e) two ranks on the
                   card: "cpu only", decided before running, since gloo
                   carries no send / recv for CUDA tensors (the ring of
                   the int8 error-feedback all-reduce). The walls of (a)
                   and (b) beside devices=None's, with the card's name
                   and power limit
  jaxsim           the §6.6.4 FLB-NUB study (repro_torch.core.jaxsim):
                   benchmarks/tables.py's 12 points over nasa_ipsc(0) +
                   worldcup98(0, 128), two weeks, float32, through the
                   jaxsim kernel in ONE launch; every row equal to
                   results/tables.json["jaxsim_sweep"] and to the plain
                   version's on the card (counts and node-hours exact,
                   avg_turnaround rtol 1e-5), B 25 inside the reference's
                   band of the event engine (completed +-2, node-hours and
                   peak 15 %); then the full factorial of the study's
                   values (5 B x 4 U x 3 V x 3 G = 180 lanes) as one launch
                   against the plain version; kernel device ms (CUDA
                   events behind a spin), the plain version's wall, the
                   bound and the serial chain beside it
  attn_kernel_vs_plain, decode_kernel_vs_plain
                   gemma2-2b's attention at full width (8 / 4 heads of
                   256, softcap 50): flash attention at S 8192 and 4600,
                   flash decode at batch 8 over an 8192 cache at four
                   positions; window 4096 and none, float32 and bfloat16,
                   plus one case each whose scores reach the softcap, and
                   bfloat16 attention at the generate phase's prefill
                   shape (batch 8, S 4600); granite-moe-3b's (24 / 8
                   heads of 64, no window, no softcap) at S 4600 and at
                   the four decode positions, float32 and bfloat16; each
                   against its plain
                   version on the same inputs (elementwise atol + rtol,
                   stated per dtype), with its device time (CUDA events
                   around calls queued behind a spin), the achieved
                   TFLOP/s (attention) or GB/s (decode) and the share of
                   the bound (float32 attention: of the 3 x TF32
                   tensor-core bound and of the CUDA cores'), the plain
                   version's time, one SDPA call's (softcap off; with a
                   window an explicit mask) and the bound
  serve            gemma2-2b at full width, float32: AutoscaledService of
                   Replicas sharing one Model, 8 requests of 500-6000
                   prompt tokens; all complete, 26 flash-attention
                   launches per admission, each admission's logits equal
                   a plain prefill's; a profile of one prefill and one
                   decode step
  generate         gemma2-2b, bfloat16: batch-8 prefill of 4600 tokens,
                   32 decode steps at one position through flash decode
                   (26 launches a step), teacher-forced against the
                   plain route (logits within 0.25, argmax agreement at
                   least 0.9); a profile of the prefill and of one step,
                   with the flash-attention (prefill) and flash-decode
                   (step) device ms as fields
  serve_moe, generate_moe
                   granite-moe-3b (40 experts, top-8) at full width and
                   depth, random weights from seed 0, as serve and
                   generate: float32 serving of the same 8 requests (32
                   flash-attention launches per admission, prefill logits
                   within 1e-4 of the plain path, peak memory); bfloat16
                   generation at batch 8 (32 + 32 x 32 launches, the same
                   logits and argmax limits)
  ssd_kernel_vs_plain
                   mamba2-130m's SSD scan at full width (24 heads, P 64,
                   N 128, chunk 128): batch 1 and 8 at L 4096, L 2048
                   with a nonzero start state, and the strongest decay
                   (a = -16 dt), float32 and bfloat16 x / B / C, each
                   against its plain version (elementwise atol + rtol,
                   stated per dtype); at L 512 also against the
                   token-by-token recurrence; device times of both
                   (CUDA events, calls queued behind a spin), the kernel
                   launches per call (a profiler trace; must be 1), the
                   bound (tensor cores: float32 at the 3 x TF32 rate,
                   with the CUDA cores' beside it) and, without a start
                   state, the chain's cost: the call's time less that of
                   the same chunks as rows of one chunk each
  serve_mamba      mamba2-130m at full width, float32: AutoscaledService
                   of Replicas sharing one Model, 8 requests of
                   512-4096 prompt tokens; all complete, 24 SSD launches
                   per admission, each admission's logits and SSM state
                   equal a plain prefill's; the longest prefill's device
                   split (SSD kernel ms)
  generate_mamba   mamba2-130m, bfloat16: batch-8 prefill of 4096 tokens
                   (24 SSD launches), 32 decode steps (plain tensor code,
                   as in the reference), teacher-forced against the plain
                   route (logits within 0.25, argmax agreement at least
                   0.9); the prefill's device split (SSD kernel ms)
  the last two families (kernel cases added to attn_kernel_vs_plain,
  decode_kernel_vs_plain and ssd_kernel_vs_plain, lines of those names)
                   attention at hd 128, G 8 (llama-3.2-vision's and
                   jamba's layers: 64 / 8 heads, no window, no softcap)
                   in bfloat16 at batch 8, S 2048 and S 1024 and in
                   float32 at batch 1, S 2048, and at hd 64, G 1
                   (whisper's decoder: 8 / 8 heads) in bfloat16 at batch
                   8 and float32 at batch 1, S 416; decode at both
                   shapes at each generate phase's first and last
                   position, both dtypes; the SSD scan at jamba's widths
                   (128 heads of P 128, N 128, one B / C group) through
                   ops.ssd, which copies B / C to each head: bfloat16 at
                   batch 8, L 2048, float32 at batch 1, L 2048 with a
                   start state, with the kernel's time alone and
                   ops.ssd's beside it
  serve_whisper    whisper-base at full width and depth (6 encoder and 6
                   decoder layers, 1500 frames), float32: 8 requests of
                   64-416 prompt tokens into the decoder's 448-token
                   context, the serving engine's frontend of zeros; 6
                   flash-attention launches per admission (the encoder's
                   bidirectional attention is plain tensor code, as in
                   the reference), each admission's logits equal a plain
                   prefill's
  generate_whisper, generate_vision, generate_hybrid
                   as generate, bfloat16, batch 8, 32 steps: whisper-base
                   (prompt 416, context 448, a random 1500-frame
                   frontend; 6 + 6 x 32 launches), llama-3.2-vision-90b
                   at full width and 10 of its 100 layers (8
                   self-attention, 2 cross-attention; prompt 1024, a
                   random 1601-patch frontend; 8 + 8 x 32 launches, the
                   cross layers none) and jamba-1.5-large at full width
                   for its mixers, one period of 8 layers, d_ff cut to
                   3072 (prompt 2048; 1 flash attention, 7 SSD, 32 flash
                   decode launches; the plain route replays the kernel
                   route's MoE routing, as generate_moe); each phase
                   lists its cuts in ``reduced``
  chaos            the chaos tier at the paper's scale: FB at C 135 over
                   two weeks (NASA iPSC, WorldCup peak 128, lease 1 h,
                   float32), one pack of three lanes, each with its own
                   fault schedule (MTBF 6, 24, 96 h), through rounds_grids
                   on the card, where a fault pack resolves to the plain
                   round step (kernel "torch"; the CUDA step has no fault
                   stops): no kernel launch; completed / kills / rounds
                   equal the JAX package's rows; rows equal the same pack
                   on the CPU (integrals rtol 1e-5) and lie inside
                   CONTRACTS["faults"] of the event engine, which loses
                   no job; LiveCloud with the schedule writes the event
                   engine's checkpoint-preempt ledger entry for entry;
                   kernel="cuda" refuses the pack. Then
                   results/BENCH_faults.json's configuration (2 days, C
                   32, MTBF 2 / 6 / 24 / 96 h): its rounds rows and
                   live_ledger_exact. Wall, outer steps, the host loop's
                   share and one step's device profile
  scan             mode="scan" (the fixed-dt engine: plain tensor code, no
                   kernel) over the JAX package's scan benchmark: three
                   two-week workloads x 15 FB / FLB-NUB points, float32;
                   every row equal to the JAX package's
                   (results/BENCH_sweep.json's rows and SCAN_EXPECTED:
                   counts exact, integrals rtol 1e-5), workload 0 inside
                   CONTRACTS["scan"] of the event engine; the wall split
                   into pack and engine, substeps per policy, the host
                   loop's share and one substep's device profile
  scenarios        a generated ScenarioGrid at width 1024 (205 seeds x 5
                   points, two weeks, 3000 jobs a lane, the scenario
                   benchmark's parameter ramps) through
                   run_sweep_workloads: 2 round_step launches (615 FB and
                   410 FLB-NUB lanes); every lane's moments, a second
                   synthesis equal, the CPU's synthesis equal up to the
                   transforms' rounding, every row equal to the plain
                   step's on the same batch (counts exact, integrals rtol
                   1e-5), lanes {0, W/2, W-1} inside CONTRACTS["rounds"]
                   of the event engine, and at width 45 the kernel's rows
                   equal to the plain step's; synth /
                   pack / engine walls, outer steps, each launch's device
                   ms and bound
  live             replay() of the live benchmark's nasa+worldcup lane
                   inside CONTRACTS["live"] of the event engine and equal
                   to the JAX package's row and counts, its synth_ws lane
                   (drawn by the port) inside CONTRACTS["live"], and the
                   faults benchmark's serving chaos lane (MTBF 2 h,
                   max_queue 64): requests completed, shed, grant
                   retries; host walls
  train_full       training on the card (repro_torch.train: the plain
                   path under autograd, as the reference trains its XLA
                   path; no kernel launches): gemma2-2b at full width and
                   depth (2.61 B params), float32, AdamW, TrainJobConfig's
                   defaults (batch 8, seq_len 128, lr 3e-4), 12 steps, no
                   checkpoint directory; the same initial weights and the
                   step-0 batch first evaluated in float64 (loss and grad
                   norm), the float32 step 0 held to them (rtol 1e-4 /
                   1e-3), the trainer's weights equal to the float64
                   model's; every loss finite and the last four steps'
                   mean below the first four's; step seconds, tokens/s,
                   peak memory, model TFLOP/s and a profiled step's busy
                   share and top device ops; the dry run's count of the
                   same step (launch.cells.analytic_cost) beside the hand
                   count, its products within 1 % of the hand count less
                   the products the remat does not redo plus the score
                   products
  sharded_train_full
                   gemma2-2b at full width and depth through the DTensor
                   path (Model.init then place_, the per-rank layers, the
                   vocabulary loss, the pinned gradients) on a (1, 1)
                   make_mesh layout of a one-rank nccl group: 3 steps of
                   train_full's job, losses equal to train_full's first 3
                   bit for bit; the set-up's and the steps' peak memory
                   beside the plain job's, step seconds beside its
  train_reduced    each family's reduced config (smollm, gemma2,
                   granite-moe, mamba2, jamba, llama-vision, whisper; the
                   vlm / audio with SyntheticLM's frontend): Model.loss
                   and every gradient on the card against the CPU's from
                   one seed (loss rtol 1e-5, each gradient leaf within
                   5e-4 of its largest magnitude: the CPU tests' limits
                   against the JAX package)
  train_resume     reduced smollm: 20 steps uninterrupted; a job killed
                   after step 13 with its checkpoints past step 10 lost;
                   a new job that restores at 10 and finishes: its losses
                   and weights equal the uninterrupted run's bit for bit;
                   preempt at step 8, resume to 20
  live_train       LiveCloud(capacity=8, mesh=card) with a live training
                   job (reduced smollm, 6 chips, 20 steps): five steps, a
                   WS spike to 5 preempts it through a checkpoint, the
                   spike recedes, a lease tick, run to completion; the
                   decision ledger equal to the same run's on the CPU
  dryrun_cell, dryrun_card, dryrun
                   the dry run (repro_torch.launch.dryrun): (a) all 40
                   arch x shape cells at published width, depth and
                   global batch on the meta device (dryrun --workers 8:
                   a process per architecture), two counting passes a cell (the forecast
                   with the kernels' routes, analytic_cost on the plain
                   path): no fail, the skips equal to the configs'
                   long_500k skips; one line a cell (FLOPs, bytes,
                   forecast peak, bottleneck, fits_card). (b) On the
                   card, impl "cuda": every cell whose forecast fits in
                   90 % of the card's memory at its own global batch, and
                   gemma2-2b's train_4k, prefill_32k and decode_32k at
                   the largest batch in {1, 2, 4, ...} whose forecast
                   fits (cuts in ``reduced``): the forecast peak within
                   10 % of the growth of max_memory_allocated over the
                   cell, the kernels launched as the forecast's routes,
                   a finite result of the forecast's shape; the step's
                   device ms (time_calls), model TFLOP/s and share of the
                   forecast's roofline bound, each line with the card's
                   name and power limit
  kernels          the kernel table line: each kernel's launches on its
                   path (sweep, serve, generate, generate_mamba, jaxsim,
                   serve_moe, generate_moe, serve_whisper and the three
                   new generate phases), times, bound; jaxsim with its
                   serial chain and the factorial's launch; granite's
                   attention and decode rows suffixed _moe; attention and
                   decode one row per dtype on its
                   path (flash_attention_f32: serve, flash_attention_bf16
                   and flash_decode_bf16: generate; ssd_scan_bf16:
                   generate_mamba, ssd_scan_f32: serve_mamba); round_step per
                   one-launch run of the sweep, with its outer steps, the
                   one-step entry's time per launch and the same for the
                   coalesced sweep, and the scenario batch's two runs; the
                   last two families' rows suffixed _whisper, _vision and
                   _jamba (flash_attention_f32_whisper: serve_whisper;
                   the bfloat16 rows: their generate phases;
                   ssd_scan_bf16_jamba with ops.ssd's time and the bytes
                   of its B / C copies)

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1 and prints no result. It imports only ``torch``,
``numpy`` and ``repro_torch`` (from ``src/`` beside it); the CPU tests
(``tests/test_torch_*.py``) cover the plain path at small sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import (ARCH_IDS, ATTN, MOE,  # noqa: E402
                                      get_config, reduced_config)
from repro_torch.core import jaxsim as jaxsimlib  # noqa: E402
from repro_torch.core.jobs import Job  # noqa: E402
from repro_torch.core.profiles import scale_profile  # noqa: E402
from repro_torch.core.pbj_manager import PBJPolicyParams  # noqa: E402
from repro_torch.core.runtime_bridge import LiveCloud  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.kernels import jaxsim_step as jsk  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import round_step as rsk  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.models import mlp as mlpmod  # noqa: E402
from repro_torch.models.mamba2 import dims as ssm_dims  # noqa: E402
from repro_torch.models.transformer import (FRONTEND_FAMILIES,  # noqa: E402
                                            Model)
from repro_torch.serving.autoscaler import AutoscaledService  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.replay import replay  # noqa: E402
from repro_torch.sim import rounds as roundslib  # noqa: E402
from repro_torch.sim import scan as scanlib  # noqa: E402
from repro_torch.sim import scenarios as scenarioslib  # noqa: E402
from repro_torch.sim import sweep as sweeplib  # noqa: E402
from repro_torch.sim import traces  # noqa: E402
from repro_torch.sim.capacity import headline_queries  # noqa: E402
from repro_torch.sim.contracts import (CONTRACTS,  # noqa: E402
                                       HEADLINE_CONTRACT, check_fidelity,
                                       demand_drift, no_lost_jobs)
from repro_torch.sim.engine import (build_fb, build_flb_nub,  # noqa: E402
                                    clone_jobs, run_sim, summarize)
from repro_torch.sim.faults import (burst_schedule,  # noqa: E402
                                    exponential_schedule, merge_schedules)
from repro_torch.sim.pump import DecisionLedger  # noqa: E402
from repro_torch.sim.scan import FBGrid  # noqa: E402
from repro_torch.sim.sweep import (ScanOptions, SweepPoint,  # noqa: E402
                                   _build, _pack_rounds, paper_grid,
                                   run_sweep_workloads)
from repro_torch.train.data import make_source  # noqa: E402
from repro_torch.train.trainer import TrainJob, TrainJobConfig  # noqa: E402

DAY = 24 * 3600.0
# Tolerance of the three order-dependent time integrals (turn_sum,
# exec_sum, node_seconds) by dtype; every other field is held exactly.
INTEGRAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-6}
INTEGRAL_SC = [rsk.SC_ACC0 + roundslib.ACC_KEYS.index(k)
               for k in ("turn_sum", "exec_sum", "node_seconds")]
INTEGRAL_ROW = ("avg_turnaround", "avg_execution", "node_hours")
ROUNDS_SC = rsk.SC_ACC0 + roundslib.ACC_KEYS.index("rounds")
COALESCED_SC = rsk.SC_ACC0 + roundslib.ACC_KEYS.index("coalesced")
# The coalescing batch of the coalesced phases: the engine's recommended
# opt-in (the default stays 1, as in the JAX package).
COALESCE = roundslib.COALESCE_BATCH
# H100 SXM published peaks (NVIDIA data sheet, 700 W) for the bound:
# HBM bandwidth and the non-tensor-core float32 / float64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# Table entries one active event round reads per lane: FB the rise time
# and value, the lease window's max and the tick demand; FLB-NUB the two
# fold-table entries.
TABLE_READS_PER_ROUND = {"fb": 4, "flb_nub": 2}
# aten ops the operation count takes: elementwise arithmetic, compares,
# logic and selects count their output elements; reductions and scans
# count their input elements. Copies, casts, views, gathers and stacks
# move data and count nothing.
ELEMENTWISE_OPS = {"add", "sub", "rsub", "mul", "div", "minimum", "maximum",
                   "clamp", "clamp_min", "clamp_max", "floor", "ceil",
                   "log2", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and",
                   "bitwise_or", "bitwise_not", "logical_and", "logical_or",
                   "logical_not", "where", "searchsorted"}
REDUCTION_OPS = {"sum", "amin", "amax", "min", "max", "argmax", "cumsum"}
# Barrier counts of the chain-cost probe; both timings are device-bound.
PROBE_STEPS = (1024, 5120)
# Clock cycles of the spin queued ahead of a timed run (about 25 ms on an
# H100): the host enqueues the timed calls while the device spins.
SPIN_CYCLES = 50_000_000
# A profiler trace (``marked_profile``) leads its work with this many spin
# kernels of this many clock cycles each (about 1 ms in all on an H100).
PROFILE_MARKS = 256
PROFILE_MARK_CYCLES = 1_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cut(workloads, horizon):
    return [([j for j in jobs if j.submit < horizon],
             [(t, d) for t, d in ws if t < horizon]) for jobs, ws in workloads]


class OpCount(TorchDispatchMode):
    """Counts the operations of the PyTorch calls made under it (see
    ``ELEMENTWISE_OPS`` / ``REDUCTION_OPS``)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.calls = 0          # aten calls (each one kernel launch or less)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        name = func.overloadpacket.__name__.rstrip("_")
        if name in REDUCTION_OPS:
            self.ops += args[0].numel()
        elif name in ELEMENTWISE_OPS:
            self.ops += out.numel()
        return out


def run_bound(policy, inputs, sc0, win0, sc_end, spec, lane_rounds, ops):
    """Least time a one-launch run could take: the larger of its bytes
    over HBM bandwidth and its operations over the dtype's peak rate.
    Bytes: the state in and out once, the policy scalars, the job rows
    the run admitted (each read once) and the table entries its
    ``lane_rounds`` active event rounds read. Operations: ``ops``, the
    plain version's count per active lane-round (``launch_bound``) times
    the run's active lane-rounds. Returns ``(ms, bound_by)``."""
    e = sc0.element_size()
    K = win0.shape[-1]
    admitted = int((sc_end[:, rsk.SC_NEXT_ROW] - K).clamp_min(0).sum())
    nbytes = e * (2 * sc0.numel() + 2 * win0.numel() + inputs[3].numel()
                  + 3 * admitted + TABLE_READS_PER_ROUND[policy] * lane_rounds)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops * lane_rounds / PEAK_OPS_PER_S[sc0.dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def launch_bound(policy, inputs, sc, win, spec, lane_rounds):
    """Least time one launch could take on these inputs: the larger of
    its bytes over HBM bandwidth and its operations over the dtype's peak
    rate. Bytes: the state in and out, the policy scalars, the job rows
    admitted into the slots that are not kept (plus the next row's submit
    per lane) and the table entries the ``lane_rounds`` active event
    rounds read. Operations: the plain version's own count for this
    launch (``OpCount``), which evaluates every round of every lane,
    scaled to the lane-rounds that were active. Returns ``(ms, bound_by,
    bytes, ops)``."""
    jobs, rises, wstab, prm = inputs
    e = sc.element_size()
    n_lanes, K = win.shape[0], win.shape[-1]
    admitted = n_lanes * K - int((win[:, rsk.WIN_DONE] == 0).sum())
    nbytes = e * (2 * sc.numel() + 2 * win.numel() + prm.numel()
                  + 3 * admitted + n_lanes
                  + TABLE_READS_PER_ROUND[policy] * lane_rounds)
    with OpCount() as count:
        rsk.chunk_step_ref(*inputs, sc, win, policy=policy, spec=spec)
    ops = count.ops * lane_rounds / (n_lanes * spec.compact_every)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[sc.dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def barrier_us(n_blocks, threads, dtype):
    """Measured cost of one barrier of the kernel's serial chain: the
    chain probe at the lanes' block shape, timed at two step counts."""
    out = torch.empty(n_blocks, threads, dtype=dtype, device="cuda")
    lo, hi = (time_calls(lambda: rsk.chain_probe(out, steps), 10)[0]
              for steps in PROBE_STEPS)
    return 1e3 * (hi - lo) / (2 * (PROBE_STEPS[1] - PROBE_STEPS[0]))


def compare_states(got, want, dtype, label):
    """Exact on every field but the three integrals (rtol by dtype).
    Returns the largest absolute difference seen."""
    (sc_k, win_k), (sc_p, win_p) = got, want
    exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRAL_SC]
    if not torch.equal(win_k, win_p):
        bad = (win_k != win_p).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: window differs at {bad}")
    if not torch.equal(sc_k[:, exact], sc_p[:, exact]):
        bad = (sc_k[:, exact] != sc_p[:, exact]).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: scalar state differs at {bad}: "
                             f"{sc_k[:, exact]} vs {sc_p[:, exact]}")
    torch.testing.assert_close(sc_k[:, INTEGRAL_SC], sc_p[:, INTEGRAL_SC],
                               rtol=INTEGRAL_RTOL[dtype], atol=0.0,
                               msg=label)
    return float((sc_k - sc_p).abs().max())


def time_calls(fn, n):
    """``(device ms, host ms)`` per call of ``fn`` over ``n`` back-to-back
    calls after one warm-up: CUDA events around the run (device time as
    long as the host enqueues faster than the device runs) and the host
    clock around the enqueue."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n, 1e3 * host_s / n


def queued_ms(fn, n):
    """Device ms per call of ``fn`` over ``n`` back-to-back calls: CUDA
    events around calls that the host enqueued while a spin kernel held
    the device, so the host's launch overhead does not count. Returns
    ``(ms, device_bound)``: ``device_bound`` is False when the spin ended
    before the host had enqueued every call, even at 16 times the spin;
    the time is then an upper bound."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES, 16 * SPIN_CYCLES):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        device_bound = not start.query()
        torch.cuda.synchronize()
        if device_bound:
            break
    return start.elapsed_time(stop) / n, device_bound


def sweep_lanes(workloads, horizon, dtype, device, coalesce=None):
    """The FB and FLB-NUB lanes of paper_grid(128) as the sweep packs
    them: ``[(policy, trace index, grid, pack, spec), ...]``."""
    points = [p for p in paper_grid(128) if p.system in ("fb", "flb_nub")]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None,
                       coalesce=coalesce)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec,
     flb_spec) = _pack_rounds(points, workloads, horizon, opts, device)
    return [(policy, w, grid, packs[w], spec)
            for policy, grid, packs, spec in (("fb", fb, fb_packs, fb_spec),
                                              ("flb_nub", flb, flb_packs,
                                               flb_spec))
            for w in range(len(workloads))]


def kernel_vs_plain(policy, trace, grid, pk, spec, horizon):
    """Run one trace's lanes of one policy chunk by chunk, as the sweep
    does: at every chunk the kernel and the plain version start from the
    same state; the plain result carries on for the live lanes. Then
    time both, and take the bound, at the state of the middle chunk."""
    prm = scanlib._lane_prm_tree(policy, grid, 1)
    ctx = roundslib._lane_ctx(policy, prm, pk)
    sc, win = roundslib._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    outer_max = -(-spec.max_rounds // spec.compact_every)
    dur = torch.tensor(spec.duration, dtype=sc.dtype, device=sc.device)
    sc0, win0 = sc, win
    states, rounds_run = [], []
    max_err, plain_run_s = 0.0, 0.0
    label = f"{policy} {trace} {str(sc.dtype)[6:]} batch {spec.batch}"
    for i in range(outer_max):
        live = sc[:, rsk.SC_T] < dur
        if not bool(live.any()):
            break
        states.append((sc, win))
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        torch.cuda.synchronize()
        plain_run_s += time.perf_counter() - t0
        max_err = max(max_err, compare_states(got, want, sc.dtype,
                                              f"{label} chunk {i}"))
        sc_n, win_n = want
        rounds_run.append(int((sc_n[:, ROUNDS_SC] - sc[:, ROUNDS_SC]).sum()))
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
    lane_rounds = sum(rounds_run)
    sc_plain, win_plain = sc, win
    # The engine's path: the whole loop in one launch, from the same
    # startup state, against the per-chunk kernel path (the kernel's own
    # state carried, lanes frozen as the engine freezes them): equal bit
    # for bit, integrals too, with the same step count per lane.
    sc, win = sc0, win0
    steps = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
    while True:
        live = (steps < outer_max) & (sc[:, rsk.SC_T] < dur)
        if not bool(live.any()):
            break
        sc_n, win_n = rsk.chunk_step(*inputs, sc, win, policy=policy,
                                     spec=spec)
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
        steps = steps + live.to(torch.int32)

    def run():
        return rsk.run_rounds(*inputs, sc0, win0, policy=policy, spec=spec,
                              outer_max=outer_max)

    sc_r, win_r, steps_r = run()
    if not (torch.equal(sc_r, sc) and torch.equal(win_r, win)
            and torch.equal(steps_r, steps)):
        raise AssertionError(f"{label}: the one-launch run differs from the "
                             f"per-chunk kernel path")
    if int(steps.max()) != len(states):
        raise AssertionError(f"{label}: {int(steps.max())} outer steps, "
                             f"{len(states)} chunks")
    compare_states((sc_r, win_r), (sc_plain, win_plain), sc.dtype,
                   f"{label} run vs plain")
    run_ms, run_device_bound = queued_ms(run, 3)
    mid = len(states) // 2
    mid_sc, mid_win = states[mid]

    def kernel():
        return rsk.chunk_step(*inputs, mid_sc, mid_win, policy=policy,
                              spec=spec)

    def plain():
        return rsk.chunk_step_ref(*inputs, mid_sc, mid_win, policy=policy,
                                  spec=spec)

    # Back-to-back launches are host-bound (the wrapper enqueues no
    # faster than the kernel runs), so the kernel's own time is taken
    # with the calls queued behind a spin.
    kernel_ms, device_bound = queued_ms(kernel, 50)
    kernel_host_ms = time_calls(kernel, 50)[1]
    plain_ms, plain_host_ms = time_calls(plain, 5)
    bound_ms, bound_by, nbytes, ops = launch_bound(
        policy, inputs, mid_sc, mid_win, spec, rounds_run[mid])
    ops_per_lane_round = ops / max(rounds_run[mid], 1)
    run_bound_ms, run_bound_by = run_bound(policy, inputs, sc0, win0, sc_r,
                                           spec, lane_rounds,
                                           ops_per_lane_round)
    barriers = rsk.chain_barriers(policy, spec)
    threads = -(-win.shape[-1] // 32) * 32
    b_us = barrier_us(win.shape[0], threads, sc.dtype)
    return dict(policy=policy, trace=trace, dtype=str(sc.dtype)[6:],
                batch=spec.batch, coalesced=float(sc[:, COALESCED_SC].sum()),
                horizon_days=horizon / DAY, lanes=int(sc.shape[0]),
                window=int(win.shape[-1]), job_table=int(inputs[0].shape[-1]),
                chunks=len(states), lane_rounds=lane_rounds,
                kernel_ms_per_launch=kernel_ms, ms_device_bound=device_bound,
                kernel_host_ms=kernel_host_ms, plain_ms_per_chunk=plain_ms,
                plain_host_ms=plain_host_ms, max_abs_err=max_err,
                mid_chunk=mid, mid_lane_rounds=rounds_run[mid],
                bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
                bound_ops=ops, chain_barriers=barriers, barrier_us=b_us,
                chain_ms=barriers * b_us / 1e3,
                run_equals_chunks=True, run_ms=run_ms,
                run_ms_device_bound=run_device_bound,
                run_ms_per_step=run_ms / len(states),
                plain_run_ms=1e3 * plain_run_s, run_bound_ms=run_bound_ms,
                run_bound_by=run_bound_by)


def rows_equal(a, b, rtol, label):
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k in ra:
            if k in INTEGRAL_ROW:
                if not np.isclose(ra[k], rb[k], rtol=rtol, atol=0.0):
                    raise AssertionError(f"{label} row {i} {k}: {ra[k]} vs "
                                         f"{rb[k]}")
            elif ra[k] != rb[k]:
                raise AssertionError(f"{label} row {i} {k}: {ra[k]} vs "
                                     f"{rb[k]}")


# ------------------------------------------ the chaos tier and the live tier

# FB at the headline's answer over the paper's two weeks: NASA iPSC jobs
# and WorldCup demand (peak 128), lease 3600 s, float32. Per MTBF (hours)
# the completed jobs, kills and rounds of the JAX package's
# fb_rounds_row (kernel="xla") under chaos_schedules(135, ...).
CHAOS_C = 135
CHAOS_LEASE = 3600.0
CHAOS_MTTR = 1800.0
CHAOS_EXPECTED = {6.0: (2518, 39, 13049), 24.0: (2527, 58, 8119),
                  96.0: (2601, 37, 6780)}
# results/BENCH_faults.json's configuration: 2 days, C 32, the first 120
# NASA jobs submitted in the first 60 % (sizes capped at C / 2), WorldCup
# at peak 16, MTBF 2 / 6 / 24 / 96 h.
BENCH_FAULTS_C = 32
BENCH_FAULTS_JOBS = 120
BENCH_FAULTS_PEAK = 16
# The live benchmark's nasa+worldcup lane (benchmarks/run.py
# live_benchmark, same cut and sizes as above) and the faults
# benchmark's serving lane (MTBF 2 h, max_queue 64): the JAX package's
# replay() rows and counts on these inputs. results/BENCH_live.json and
# the serving entry of results/BENCH_faults.json were written by an
# older revision of the JAX package (node_hours 1499.1083 / 1226.7257,
# adjust_events 526 / 633), so the port is held to today's.
LIVE_EXPECTED = {
    "row": {"system": "live", "completed_jobs": 120,
            "avg_turnaround": 4089.0207841682213,
            "avg_execution": 574.3528031066321,
            "node_hours": 1499.1166666666666, "peak_nodes": 32,
            "adjust_events": 525, "pbj_adjust_events": 91, "kills": 0},
    "requests_completed": 82056, "peak_instances": 16,
    "ledger_events": 722, "shed_requests": 0, "grant_retries": 0}
SERVE_CHAOS_EXPECTED = {
    "row": {"system": "live", "completed_jobs": 120,
            "avg_turnaround": 11480.276835812914,
            "avg_execution": 490.44783584256714,
            "node_hours": 1226.6167437303143, "peak_nodes": 32,
            "adjust_events": 632, "pbj_adjust_events": 198, "kills": 11},
    "requests_completed": 82056, "ledger_events": 1354,
    "shed_requests": 0, "grant_retries": 0, "failure_kills": 8}


def chaos_schedules(capacity, horizon, mtbf_hours):
    """The faults benchmark's schedule per MTBF: independent node
    failures (half the capacity's nodes, MTTR 30 min) merged with bursts
    of a quarter of the capacity at a quarter of the rate (MTTR 1 h)."""
    return [merge_schedules(
        exponential_schedule(seed=7, n_nodes=capacity // 2,
                             mtbf=h * 3600.0, mttr=CHAOS_MTTR,
                             duration=horizon),
        burst_schedule(seed=11, k=max(1, capacity // 4),
                       mtbf=4 * h * 3600.0, mttr=2 * CHAOS_MTTR,
                       duration=horizon)) for h in mtbf_hours]


def bench_faults_workload(horizon):
    capacity = BENCH_FAULTS_C
    jobs = [Job(jid=i, submit=j.submit, size=min(j.size, capacity // 2),
                runtime=j.runtime)
            for i, j in enumerate(j for j in traces.nasa_ipsc(seed=0)
                                  if j.submit < horizon * 0.6)]
    return (jobs[:BENCH_FAULTS_JOBS],
            traces.worldcup98(seed=0, peak_vms=BENCH_FAULTS_PEAK,
                              duration=horizon))


def fault_lanes(jobs, ws, capacity, horizon, scheds, device):
    """One FB pack of one lane per schedule (same jobs and demand) on
    ``device``, its grid and its spec (kernel None: resolved per pack)."""
    spec = roundslib.RoundsSpec(
        duration=horizon, window=roundslib.FB_ROUNDS_WINDOW,
        max_rounds=roundslib.round_budget(len(jobs), len(ws), horizon,
                                          CHAOS_LEASE)
        + 8 * max(len(s) for s in scheds))
    pk = roundslib.pack_event_workloads(
        [(jobs, ws)] * len(scheds), horizon, spec.window, "fb",
        [CHAOS_LEASE], [float(capacity)], faults=scheds, device=device)
    grid = FBGrid(capacity=torch.tensor([float(capacity)], device=device),
                  lease=torch.tensor([CHAOS_LEASE], device=device))
    return grid, pk, spec


def lane_rows(out):
    """The (W, 1) metric tensors of rounds_grids as one row per lane."""
    W = out["completed_jobs"].shape[0]
    rows = [{k: float(v[w, 0]) for k, v in out.items()} for w in range(W)]
    for r in rows:
        for k in ("completed_jobs", "peak_nodes"):
            r[k] = int(round(r[k]))
    return rows


def event_and_live(jobs, ws, capacity, horizon, sched):
    """One schedule through the event engine (kill mode: its row and the
    no-lost-jobs invariant) and through LiveCloud against the event
    engine in checkpoint-preempt mode (ledgers entry for entry and
    node-hours)."""
    ev_sys = build_fb(capacity, CHAOS_LEASE)
    ev_jobs = clone_jobs(jobs)
    ev = run_sim(ev_sys, ev_jobs, ws, duration=horizon, name="event",
                 faults=sched)
    lost = no_lost_jobs(ev_jobs, ev_sys)
    ck_led = DecisionLedger()
    ck_sys = build_fb(capacity, CHAOS_LEASE,
                      params=PBJPolicyParams(checkpoint_preempt=True))
    ck_jobs = clone_jobs(jobs)
    ck = run_sim(ck_sys, ck_jobs, ws, duration=horizon, name="event_ckpt",
                 ledger=ck_led, faults=sched)
    lost += no_lost_jobs(ck_jobs, ck_sys)
    d0 = max((int(d) for t, d in ws if t <= 0), default=0)
    cloud = LiveCloud(capacity, lease_seconds=CHAOS_LEASE, duration=horizon,
                      ws_initial=d0)
    cloud.load_trace(clone_jobs(jobs), ws_trace=ws, lease_ticks=True)
    cloud.inject_faults(sched)
    cloud.run_until(horizon)
    live = summarize(cloud.service, [], horizon, "live")
    return ev, lost, dict(
        live_ledger_exact=cloud.ledger.entries == ck_led.entries
        and live.node_hours == ck.node_hours,
        ledger_events=len(ck_led.entries),
        failure_kills=ck_led.kills("fail"))


def chaos_phase(device, smi):
    """The chaos tier on the card: the paper-scale lanes (one pack, one
    schedule per MTBF) through rounds_grids on cuda, which resolves a
    fault pack to the plain step (the CUDA round step has no fault
    stops, as the JAX package's fused step has none), against the event
    engine, the table of the JAX package's rows, the same pack on the
    CPU and LiveCloud; then results/BENCH_faults.json's configuration."""
    horizon = traces.TWO_WEEKS
    jobs = traces.nasa_ipsc(seed=0)
    ws = traces.worldcup98(seed=0, peak_vms=128)
    mtbf = tuple(CHAOS_EXPECTED)
    scheds = chaos_schedules(CHAOS_C, horizon, mtbf)
    t0 = time.perf_counter()
    grid, pk, spec = fault_lanes(jobs, ws, CHAOS_C, horizon, scheds, device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    kernel = spec.resolve_kernel(pk.device, pk.fault_times is not None)
    if kernel != "torch":
        raise AssertionError(f"a fault pack resolved to {kernel!r}")
    # The outer steps: the plain step's calls, timed on the host (the
    # loop synchronises once per step to test its lanes).
    loop = {"steps": 0, "s": 0.0}
    step_ref = rsk.chunk_step_ref

    def counted(*args, **kwargs):
        t1 = time.perf_counter()
        out = step_ref(*args, **kwargs)
        loop["s"] += time.perf_counter() - t1
        loop["steps"] += 1
        return out

    zero_counts()
    rsk.chunk_step_ref = counted
    try:
        t0 = time.perf_counter()
        out = roundslib.rounds_grids(grid, None, pk, None, fb_spec=spec)["fb"]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        rsk.chunk_step_ref = step_ref
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the fault lanes launched a kernel: {counts}")
    rows = lane_rows(out)
    # One outer step's device share: a profile of one plain step from
    # the lanes' startup state.
    prm = scanlib._lane_prm_tree("fb", grid, len(scheds))
    ctx = roundslib._lane_ctx("fb", prm, pk)
    sc0, win0 = roundslib._startup("fb", ctx, spec, pk.ws0[prm["w_idx"]])
    ftab = rsk.fault_table(ctx)
    inputs = rsk.lane_inputs("fb", ctx, ftab)
    step = breakdown(lambda: rsk.chunk_step_ref(
        *inputs, sc0, win0, policy="fb", spec=spec, ftab=ftab))
    # The same pack on the CPU, plain step.
    t0 = time.perf_counter()
    cgrid, cpk, _ = fault_lanes(jobs, ws, CHAOS_C, horizon, scheds, "cpu")
    cpu_rows = lane_rows(roundslib.rounds_grids(cgrid, None, cpk, None,
                                                fb_spec=spec)["fb"])
    cpu_s = time.perf_counter() - t0
    rows_equal(rows, cpu_rows, INTEGRAL_RTOL[torch.float32],
               "chaos cuda vs cpu")
    lanes = []
    for h, sched, row in zip(mtbf, scheds, rows):
        got = (row["completed_jobs"], int(row["kills"]), int(row["rounds"]))
        if got != CHAOS_EXPECTED[h] or row["truncated"] or \
                row["window_overflow"]:
            raise AssertionError(f"chaos MTBF {h} h: (completed, kills, "
                                 f"rounds) {got}, expected "
                                 f"{CHAOS_EXPECTED[h]}; {row}")
        ev, lost, live = event_and_live(jobs, ws, CHAOS_C, horizon, sched)
        violations = CONTRACTS["faults"].check_row(row, ev.row())
        if violations or lost or not live["live_ledger_exact"]:
            raise AssertionError(f"chaos MTBF {h} h: contract "
                                 f"{violations}, lost {lost}, {live}")
        lanes.append(dict(mtbf_h=h, schedule_events=len(sched), rounds=row,
                          event=ev.row(), **live))
    zero_counts()
    cuda_spec = dataclasses.replace(spec, kernel="cuda")
    try:
        roundslib.rounds_grids(grid, None, pk, None, fb_spec=cuda_spec)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("kernel=\"cuda\" ran a fault pack")
    if any(read_counts().values()):
        raise AssertionError(f"the refused run launched: {read_counts()}")

    # results/BENCH_faults.json's configuration, one pack of four lanes.
    bench = json.loads((ROOT / "results" / "BENCH_faults.json"
                        ).read_text())
    b_horizon = bench["horizon_s"]
    b_jobs, b_ws = bench_faults_workload(b_horizon)
    b_mtbf = tuple(lane["mtbf_h"] for lane in bench["lanes"])
    b_scheds = chaos_schedules(BENCH_FAULTS_C, b_horizon, b_mtbf)
    t0 = time.perf_counter()
    bgrid, bpk, bspec = fault_lanes(b_jobs, b_ws, BENCH_FAULTS_C, b_horizon,
                                    b_scheds, device)
    b_rows = lane_rows(roundslib.rounds_grids(bgrid, None, bpk, None,
                                              fb_spec=bspec)["fb"])
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    b_lanes = []
    for lane, sched, row in zip(bench["lanes"], b_scheds, b_rows):
        want = lane["rounds"]
        bad = [k for k in ("completed_jobs", "kills", "rounds")
               if row[k] != want[k]]
        if bad or not np.isclose(row["node_hours"], want["node_hours"],
                                 rtol=INTEGRAL_RTOL[torch.float32], atol=0):
            raise AssertionError(f"BENCH_faults MTBF {lane['mtbf_h']} h: "
                                 f"{row} vs {want}")
        ev, lost, live = event_and_live(b_jobs, b_ws, BENCH_FAULTS_C,
                                        b_horizon, sched)
        violations = CONTRACTS["faults"].check_row(row, ev.row())
        if violations or lost or not live["live_ledger_exact"]:
            raise AssertionError(f"BENCH_faults MTBF {lane['mtbf_h']} h: "
                                 f"contract {violations}, lost {lost}, "
                                 f"{live}")
        b_lanes.append(dict(mtbf_h=lane["mtbf_h"], rounds=row,
                            json_rounds=want, **live))
    emit("chaos", card=smi, kernel=kernel,
         note="fault packs run the plain round step on the card "
              "(kernel=None resolves to \"torch\"; the CUDA step has no "
              "fault stops and kernel=\"cuda\" refuses them)",
         capacity=CHAOS_C, horizon_days=horizon / DAY, dtype="float32",
         lanes=lanes, wall_s=wall_s, pack_s=pack_s,
         outer_steps=loop["steps"], host_loop_s=loop["s"],
         host_loop_share=loop["s"] / wall_s, one_step=step,
         cpu_plain_wall_s=cpu_s, cuda_rows_equal_cpu=True,
         kernel_launches=counts, cuda_refused=refused,
         bench_faults={"capacity": BENCH_FAULTS_C,
                       "horizon_days": b_horizon / DAY, "wall_s": b_wall,
                       "lanes": b_lanes})


def replay_summary(res):
    return dict(row=res.row.row(), requests_completed=res.requests_completed,
                peak_instances=res.peak_instances,
                ledger_events=len(res.ledger.entries),
                shed_requests=res.shed_requests,
                grant_retries=res.grant_retries,
                failure_kills=res.ledger.kills("fail"))


def hold_to(got, want, label):
    """Every key of ``want`` (and of its row) equal in ``got``; floats to
    rtol 1e-12 (the same Python arithmetic on another host)."""
    pairs = [(k, got[k], v) for k, v in want.items() if k != "row"]
    pairs += [(f"row.{k}", got["row"][k], v) for k, v in want["row"].items()]
    for k, g, v in pairs:
        ok = (np.isclose(g, v, rtol=1e-12, atol=0)
              if isinstance(v, float) else g == v)
        if not ok:
            raise AssertionError(f"{label} {k}: {g}, expected {v}")


def live_phase(device, smi):
    """The live tier: replay() of the live benchmark's nasa+worldcup lane
    (autoscaler + VirtualReplica on LiveCloud's pump) inside
    CONTRACTS["live"] of the event engine, its synth_ws lane (drawn by
    the port's generators on the card), and the faults benchmark's
    serving chaos lane; host work, on the port's event pump."""
    bench = json.loads((ROOT / "results" / "BENCH_faults.json"
                        ).read_text())
    horizon = bench["horizon_s"]
    jobs, ws = bench_faults_workload(horizon)
    t0 = time.perf_counter()
    ref = run_sim(build_fb(BENCH_FAULTS_C, params=PBJPolicyParams(
        checkpoint_preempt=True)), clone_jobs(jobs), ws, duration=horizon,
        name="event")
    event_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = replay(clone_jobs(jobs), ws, BENCH_FAULTS_C, duration=horizon,
                 serve_dt=30.0)
    live_s = time.perf_counter() - t0
    violations = CONTRACTS["live"].check_live(
        res.row.row(), ref.row(), res.derived_demand, res.trace_demand,
        horizon)
    if violations:
        raise AssertionError(f"live contract violated: {violations}")
    live = replay_summary(res)
    hold_to(live, LIVE_EXPECTED, "live nasa+worldcup")
    mae, dpeak = demand_drift(res.derived_demand, res.trace_demand, horizon)
    sched, = chaos_schedules(BENCH_FAULTS_C, horizon, (2.0,))
    t0 = time.perf_counter()
    res_c = replay(clone_jobs(jobs), ws, BENCH_FAULTS_C, duration=horizon,
                   serve_dt=30.0, faults=sched, max_queue=64)
    chaos_s = time.perf_counter() - t0
    serving = replay_summary(res_c)
    hold_to(serving, SERVE_CHAOS_EXPECTED, "serving chaos")
    # The live benchmark's synth_ws lane (benchmarks/run.py, its lines
    # 938-945), drawn by the port: other draws than the JAX package's.
    sgrid = scenarioslib.ScenarioGrid(
        seeds=(5,), pbj=scenarioslib.PBJParams(
            nodes=float(BENCH_FAULTS_C), utilization=0.45, n_jobs=90.0),
        ws=scenarioslib.WSParams(peak=float(BENCH_FAULTS_PEAK),
                                 base_mean=3.0),
        duration=horizon, max_jobs=200, ws_step=900.0)
    (sjobs, sws), = scenarioslib.sample_workloads(
        scenarioslib.synthesize(sgrid, device), [0])
    ref_s = run_sim(build_fb(BENCH_FAULTS_C, params=PBJPolicyParams(
        checkpoint_preempt=True)), clone_jobs(sjobs), sws, duration=horizon,
        name="event")
    t0 = time.perf_counter()
    res_s = replay(clone_jobs(sjobs), sws, BENCH_FAULTS_C, duration=horizon,
                   serve_dt=30.0)
    synth_s = time.perf_counter() - t0
    violations = CONTRACTS["live"].check_live(
        res_s.row.row(), ref_s.row(), res_s.derived_demand,
        res_s.trace_demand, horizon)
    if violations:
        raise AssertionError(f"live synth_ws contract violated: "
                             f"{violations}")
    s_mae, s_dpeak = demand_drift(res_s.derived_demand, res_s.trace_demand,
                                  horizon)
    emit("live", card=smi, host_wall_s=live_s, event_wall_s=event_s,
         note="host work on the port's event pump",
         lane="nasa+worldcup", event=ref.row(), **live,
         demand_mae_rel=mae, demand_peak_rel=dpeak, contract_ok=True,
         synth_ws=dict(jobs=len(sjobs), ws_steps=len(sws), event=ref_s.row(),
                       host_wall_s=synth_s, demand_mae_rel=s_mae,
                       demand_peak_rel=s_dpeak, contract_ok=True,
                       **replay_summary(res_s)),
         serving_chaos=dict(mtbf_h=2.0, max_queue=64, host_wall_s=chaos_s,
                            **serving))


# --------------------------- the scan engine and generated scenario batches

# The §6.6.4 FLB-NUB study (repro_torch.core.jaxsim): benchmarks/tables.py's
# jaxsim_sweep grid (its lines 287-293), whose rows are in
# results/tables.json["jaxsim_sweep"], and the full factorial of its values.
JAXSIM_STUDY = (
    [{"B": b, "U": 1.2, "V": 0.2, "G": 0.5} for b in (13, 25, 51, 102, 154)]
    + [{"B": 25, "U": u, "V": 0.2, "G": 0.5} for u in (1.0, 1.5, 2.0)]
    + [{"B": 25, "U": 1.2, "V": v, "G": 0.5} for v in (0.1, 0.5)]
    + [{"B": 25, "U": 1.2, "V": 0.2, "G": g} for g in (0.25, 0.99)])
JAXSIM_FACTORIAL = [{"B": b, "U": u, "V": v, "G": g}
                    for b in (13, 25, 51, 102, 154) for u in (1.0, 1.2, 1.5,
                                                              2.0)
                    for v in (0.1, 0.2, 0.5) for g in (0.25, 0.5, 0.99)]
# Counts and node-hours exactly (integer-valued sums); the turnaround sum
# is order-dependent (float32: rtol 1e-5).
JAXSIM_EXACT = ("completed_jobs", "peak_nodes", "adjust_events", "node_hours")
# Operations the study needs per job and substep while the job is live
# (submitted, not finished): running, its remaining time less dt, the
# completion compare and its size into `used`; queued, the fit compare
# and its size into `demand` and `biggest`. Plus one subtraction from the
# free count per start. Compares, adds and max are one instruction each.
JAXSIM_OPS_PER_LIVE_PAIR = 3
# One such instruction per lane and clock: the FMA-doubled peaks halved.
PEAK_INSTR_PER_S = {k: v / 2 for k, v in PEAK_OPS_PER_S.items()}
# Block barriers a substep of csrc/jaxsim.cu passes in sequence.
JAXSIM_BARRIERS = 2
JAXSIM_THREADS = 256
# Shared-memory bytes an SM serves per clock (32 banks of 4 bytes).
SMEM_BYTES_PER_CLOCK = 128


def hold_jaxsim_rows(got, want, label):
    """Row by row: counts and node-hours exact, avg_turnaround within
    INTEGRAL_RTOL; returns the largest absolute difference."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, expected "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        bad = {k: (a[k], b[k]) for k in JAXSIM_EXACT if a[k] != b[k]}
        if bad or {k: a[k] for k in "BUVG"} != {k: b[k] for k in "BUVG"}:
            raise AssertionError(f"{label} row {i} ({a}): {bad}")
        if abs(a["avg_turnaround"] - b["avg_turnaround"]) > \
                INTEGRAL_RTOL[torch.float32] * abs(b["avg_turnaround"]):
            raise AssertionError(f"{label} row {i}: avg_turnaround "
                                 f"{a['avg_turnaround']} vs "
                                 f"{b['avg_turnaround']}")
    return max(abs(a[k] - b[k]) for a, b in zip(got, want)
               for k in jsk.OUTPUTS)


def jaxsim_run(grid, jobs, ws, device, impl=None):
    """One call of the study's entry point, synchronized: (rows, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = jaxsimlib.sweep(grid, jobs, ws, traces.TWO_WEEKS, device=device,
                           impl=impl)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def jaxsim_bound(rows, n_jobs, n_steps, dtype, in_smem):
    """Least time for a study (the larger of bytes over HBM bandwidth,
    each input read once and each output written once, and the
    operations this run's jobs need over the instruction rate), and two
    modelled floors of the kernel's own design: the serial chain
    (JAXSIM_BARRIERS barriers a substep at the barrier cost measured by
    round_step's chain probe) and a lane's pass over its job table each
    substep (flag, size and one time column a job) at one SM's
    shared-memory rate (HBM's when the table is in global memory).

    The operations count the (job, substep) pairs in which a completed
    job was live, sum(turnaround) / dt per lane from the run's rows; jobs
    still queued or running at the horizon are left out, so it is a
    floor."""
    e, lanes = dtype.itemsize, len(rows)
    dt = 3600.0 / jaxsimlib.SUBSTEPS
    nbytes = e * (3 * n_jobs + n_steps + 4 * lanes + len(jsk.OUTPUTS)
                  * lanes)
    live = sum(r["completed_jobs"] * r["avg_turnaround"] / dt for r in rows)
    ops = JAXSIM_OPS_PER_LIVE_PAIR * live + sum(r["completed_jobs"]
                                                for r in rows)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_INSTR_PER_S[dtype]
    chain_ms = n_steps * JAXSIM_BARRIERS * barrier_us(
        lanes, JAXSIM_THREADS, dtype) / 1e3
    props = torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.split()[0])
    per_sm = -(-lanes // props.multi_processor_count)
    rate = SMEM_BYTES_PER_CLOCK * mhz * 1e6 if in_smem \
        else HBM_BYTES_PER_S / props.multi_processor_count
    table_ms = 1e3 * n_steps * per_sm * n_jobs * (1 + 2 * e) / rate
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops, live_job_substeps=live,
                chain_bound_ms=chain_ms, table_bound_ms=table_ms,
                sm_clock_mhz=mhz)


def jaxsim_timing(grid, rows, jobs, ws, device):
    """The kernel's device ms per launch (CUDA events, queued behind a
    spin) on the study's pack, and at half its substeps: the difference
    gives the measured cost of a substep and the fixed cost of a launch
    (the first week's load may differ from the second's). These launches
    are not the main path's."""
    table = jaxsimlib.pack_trace(jobs, ws, traces.TWO_WEEKS, 3600.0,
                                 device=device)
    prm = torch.tensor([[p[k] for k in "BUVG"] for p in grid],
                       dtype=torch.float32, device=device)
    n_steps = table[4]
    before = jsk.simulate_kernel.launches
    ms, half_ms = (queued_ms(lambda: jsk.simulate_kernel(
        prm, *table[:3], table[3][:n], n_steps=n, lease_seconds=3600.0), 3)
        for n in (n_steps, n_steps // 2))
    jsk.simulate_kernel.launches = before
    substep_ms = (ms[0] - half_ms[0]) / (n_steps - n_steps // 2)
    in_smem = jsk.fits_shared_memory(len(jobs), torch.float32, device)
    return dict(ms=ms[0], ms_device_bound=ms[1] and half_ms[1],
                half_steps_ms=half_ms[0], substep_us=1e3 * substep_ms,
                fixed_ms=ms[0] - n_steps * substep_ms, n_jobs=len(jobs),
                n_steps=n_steps, in_shared_memory=in_smem,
                **jaxsim_bound(rows, len(jobs), n_steps, torch.float32,
                               in_smem))


def jaxsim_phase(device, smi):
    """The §6.6.4 study through the kernel: one launch; rows equal the
    recorded JAX rows and the plain version's on the card; B 25 inside
    the reference's band of the event engine; then the 180-lane factorial
    as one launch against the plain version."""
    jobs = traces.nasa_ipsc(seed=0)
    ws = traces.worldcup98(seed=0, peak_vms=128)
    jaxsimlib.sweep(JAXSIM_STUDY[:1], jobs[:16], ws, DAY, device=device)
    zero_counts()
    rows, wall_s = jaxsim_run(JAXSIM_STUDY, jobs, ws, device)
    counts = read_counts()
    if counts["jaxsim"] != 1 or any(v for k, v in counts.items()
                                    if k != "jaxsim"):
        raise AssertionError(f"jaxsim study launches: {counts}")
    recorded = json.loads((ROOT / "results" / "tables.json").read_text())[
        "jaxsim_sweep"]
    err_recorded = hold_jaxsim_rows(rows, recorded, "jaxsim vs tables.json")
    before = jsk.simulate_kernel.launches
    plain, plain_s = jaxsim_run(JAXSIM_STUDY, jobs, ws, device, "torch")
    if jsk.simulate_kernel.launches != before:
        raise AssertionError("the plain study launched the kernel")
    err_plain = hold_jaxsim_rows(rows, plain, "jaxsim kernel vs plain")
    t0 = time.perf_counter()
    ev = run_sim(build_flb_nub(13, 12), clone_jobs(jobs), ws,
                 traces.TWO_WEEKS)
    event_s = time.perf_counter() - t0
    b25 = rows[1]
    band = dict(completed=abs(b25["completed_jobs"] - ev.completed_jobs),
                node_hours_rel=abs(b25["node_hours"] - ev.node_hours)
                / ev.node_hours,
                peak_rel=abs(b25["peak_nodes"] - ev.peak_nodes)
                / ev.peak_nodes)
    if not (band["completed"] <= 2 and band["node_hours_rel"] < 0.15
            and band["peak_rel"] < 0.15):
        raise AssertionError(f"jaxsim B 25 outside the event band: {band}")
    timing = jaxsim_timing(JAXSIM_STUDY, rows, jobs, ws, device)
    # the full factorial as one launch, against the plain version
    before = jsk.simulate_kernel.launches
    fac, fac_wall_s = jaxsim_run(JAXSIM_FACTORIAL, jobs, ws, device)
    fac_launches = jsk.simulate_kernel.launches - before
    fac_plain, fac_plain_s = jaxsim_run(JAXSIM_FACTORIAL, jobs, ws, device,
                                        "torch")
    if fac_launches != 1:
        raise AssertionError(f"the factorial made {fac_launches} launches")
    err_fac = hold_jaxsim_rows(fac, fac_plain, "jaxsim factorial vs plain")
    fac_timing = jaxsim_timing(JAXSIM_FACTORIAL, fac, jobs, ws, device)
    out = dict(lanes=len(JAXSIM_STUDY), launches=counts["jaxsim"],
               wall_s=wall_s, plain_s=plain_s, event_s=event_s,
               max_abs_err_vs_plain=err_plain,
               max_abs_err_vs_recorded=err_recorded, event_band=band,
               **timing, factorial=dict(
                   lanes=len(JAXSIM_FACTORIAL), launches=fac_launches,
                   wall_s=fac_wall_s, plain_s=fac_plain_s,
                   max_abs_err_vs_plain=err_fac, **fac_timing),
               rows=rows, nvidia_smi=smi)
    emit("jaxsim", **out)
    return out


# The JAX package's scan benchmark (benchmarks/run.py, its lines 174-195):
# three two-week workloads and 15 FB / FLB-NUB points. Its rows in
# results/BENCH_sweep.json (``comparisons[*].fast``) are today's reference
# rows (checked against repro.sim.scan.scan_grids on the CPU); they hold
# no adjust events or mean times, so those come from the same reference
# run: per point, per workload (adjust_events, avg_turnaround,
# avg_execution).
SCAN_EXPECTED = {
    "FB(C=128)": (
        (1456, 3302.60474, 1073.77832), (1488, 16398.4609, 2136.40942),
        (1447, 10975.9229, 1096.75244)),
    "FB(C=154)": (
        (1456, 3191.77954, 1125.77795), (1488, 18864.9219, 2162.91406),
        (1451, 6014.98633, 1130.70715)),
    "FB(C=192)": (
        (1456, 2108.18237, 1125.77795), (1488, 7491.22949, 2162.91406),
        (1453, 3203.61279, 1130.70715)),
    "FB(C=230)": (
        (1456, 1870.64893, 1125.77795), (1488, 5740.03271, 2162.91406),
        (1454, 2366.90918, 1130.70715)),
    "FB(C=256)": (
        (1456, 1825.70154, 1125.77795), (1488, 4541.83643, 2162.91406),
        (1456, 2081.89795, 1130.70715)),
    "FLB-NUB(B=13)": (
        (3091, 1184.93408, 672.290527), (3145, 2637.78369, 2023.38977),
        (3095, 1162.30469, 682.404907)),
    "FLB-NUB(B=25)": (
        (3089, 1172.82764, 672.290527), (3146, 2633.26367, 2023.38977),
        (3095, 1162.42004, 682.404907)),
    "FLB-NUB(B=51)": (
        (3097, 1182.0509, 672.290527), (3139, 2608.51758, 2023.38977),
        (3093, 1168.98914, 682.404907)),
    "FLB-NUB(B=102)": (
        (3084, 1121.28992, 672.290527), (3156, 2576.1377, 2022.96692),
        (3103, 1139.25562, 682.404907)),
    "FLB-NUB(B=154)": (
        (3093, 1044.17993, 672.147522), (3157, 2552.86841, 2022.96692),
        (3102, 1058.57996, 682.404907)),
    "FLB-NUB(L=15min)": (
        (3785, 1147.79041, 672.147522), (3725, 2599.63867, 2023.13489),
        (3798, 1126.55493, 682.55188)),
    "FLB-NUB(L=30min)": (
        (3327, 1169.25305, 672.290527), (3354, 2604.95068, 2023.13489),
        (3354, 1125.65527, 682.404907)),
    "FLB-NUB(L=60min)": (
        (3089, 1172.82764, 672.290527), (3146, 2633.26367, 2023.38977),
        (3095, 1162.42004, 682.404907)),
    "FLB-NUB(L=120min)": (
        (2953, 1192.62256, 672.147522), (3029, 2619.28516, 2022.96692),
        (2958, 1144.67419, 682.55188)),
    "FLB-NUB(L=240min)": (
        (2888, 1146.93408, 671.856995), (2961, 2699.93311, 2022.96692),
        (2888, 1250.01147, 682.404907)),
}


def scan_workloads():
    """The scan benchmark's workloads: both §6.2 batch logs, and NASA iPSC
    (seed 1) under twice the World Cup demand."""
    ws_nasa = traces.worldcup98(seed=0, peak_vms=128)
    return [(traces.nasa_ipsc(seed=0), ws_nasa),
            (traces.sdsc_blue(seed=0), traces.worldcup98(seed=1,
                                                         peak_vms=128)),
            (traces.nasa_ipsc(seed=1), scale_profile(ws_nasa, 2.0))]


def scan_points():
    """Fig. 13 capacities, Fig. 14 pool sizes and Fig. 18 leases."""
    cs = [int(round(256 * f)) for f in (0.5, 0.6, 0.75, 0.9, 1.0)]
    return ([SweepPoint("fb", capacity=c, label=f"FB(C={c})") for c in cs]
            + [SweepPoint("flb_nub", lb_pbj=B - min(12, B - 1),
                          lb_ws=min(12, B - 1), label=f"FLB-NUB(B={B})")
               for B in (13, 25, 51, 102, 154)]
            + [SweepPoint("flb_nub", lb_pbj=13, lb_ws=12,
                          lease_seconds=60.0 * m, label=f"FLB-NUB(L={m}min)")
               for m in (15, 30, 60, 120, 240)])


def hold_scan_rows(rows, bench):
    """Every (point, workload) row against the JAX package's: completed
    jobs, kills, peak, adjust events and window overflow exact; node-hours
    and the two mean times at rtol 1e-5. Returns the rows checked."""
    names = bench["grid"]
    rtol = INTEGRAL_RTOL[torch.float32]
    for c in bench["comparisons"]:
        w, name = c["workload"], c["point"]
        row = rows[w][names.index(name)]
        adj, turn, exe = SCAN_EXPECTED[name][w]
        want = dict(c["fast"], adjust_events=adj, avg_turnaround=turn,
                    avg_execution=exe)
        for k, v in want.items():
            ok = (np.isclose(row[k], v, rtol=rtol, atol=0)
                  if k in INTEGRAL_ROW else row[k] == v)
            if not ok or row["system"] != name:
                raise AssertionError(f"scan {name} workload {w} {k}: "
                                     f"{row[k]}, the JAX package {v}")
    return len(bench["comparisons"])


def scan_phase(device, smi):
    """mode="scan" at the JAX package's scan benchmark's size on the card:
    the host loop of small tensor ops (no kernel), rows held to the JAX
    package's, CONTRACTS["scan"] against the event engine on workload 0,
    the wall split into pack and engine, the host loop's share and one
    substep's device profile per policy."""
    bench = json.loads((ROOT / "results" / "BENCH_sweep.json").read_text())
    workloads, points = scan_workloads(), scan_points()
    horizon = traces.TWO_WEEKS
    if [p.name() for p in points] != bench["grid"]:
        raise AssertionError("the scan grid differs from BENCH_sweep.json's")

    def run():
        return run_sweep_workloads(points, workloads, horizon, mode="scan",
                                   device=device)

    zero_counts()
    t0 = time.perf_counter()
    rows = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the scan engine launched a kernel: {counts}")
    checked = hold_scan_rows(rows, bench)
    # The split: pack and engine stages synchronized; inside the engine
    # the host time of the two policies' loops (no synchronize).
    loop = {"s": 0.0}
    simulate = scanlib._simulate

    def timed_loop(*args, **kwargs):
        t1 = time.perf_counter()
        out = simulate(*args, **kwargs)
        loop["s"] += time.perf_counter() - t1
        return out

    scanlib._simulate = timed_loop
    try:
        split = wall_split(run, (("pack", sweeplib, "_pack_scan"),
                                 ("engine", scanlib, "scan_grids")))
    finally:
        scanlib._simulate = simulate
    # Substeps and one substep's device profile per policy, at the
    # lanes' startup window (a substep runs the same ops on any data).
    (_, _, fb, flb, fb_pk, flb_pk, fb_spec, flb_spec) = sweeplib._pack_scan(
        points, workloads, horizon, ScanOptions(), device)
    per_policy = {}
    for policy, grid, pk, spec in (("fb", fb, fb_pk, fb_spec),
                                   ("flb_nub", flb, flb_pk, flb_spec)):
        prm = scanlib._lane_prm_tree(policy, grid, len(workloads))
        ctx = scanlib._lane_ctx(policy, prm, pk)
        jidx, _, owned, pool, run_, rem, start_t, acc = scanlib._startup(
            policy, ctx, spec)
        window = scanlib._gather_window(ctx, jidx)
        state = (owned, pool, run_, torch.zeros_like(run_), rem, start_t,
                 acc)
        s_idx = torch.zeros((), dtype=pk.ws.dtype, device=device)

        def substep():
            return scanlib._substep(policy, ctx, spec, window, state, s_idx,
                                    ctx["tr_ws"][:, 0],
                                    ctx["tr_ws_changed"][:, 0])

        with OpCount() as count:
            substep()
        n_sub = int(pk.ws.shape[1])
        per_policy[policy] = dict(
            lanes=int(prm["w_idx"].shape[0]), dt=spec.dt,
            substeps=spec.n_steps, substeps_run=n_sub,
            chunk_len=spec.chunk_len, window=spec.window,
            aten_calls_per_substep=count.calls, one_substep=breakdown(substep))
    # CONTRACTS["scan"] against the event engine on workload 0.
    jobs, ws = workloads[0]
    t0 = time.perf_counter()
    event = [run_sim(_build(p), clone_jobs(jobs), ws, horizon,
                     name=p.name()).row() for p in points]
    event_s = time.perf_counter() - t0
    violations = check_fidelity(rows[0], event)
    if violations:
        raise AssertionError(f"scan contract violated: {violations}")
    emit("scan", card=smi, points=len(points), workloads=len(workloads),
         horizon_days=horizon / DAY, dtype="float32", wall_s=wall_s,
         wall_split=split, host_loop_s=loop["s"],
         host_loop_share=loop["s"] / split["wall_s"], policies=per_policy,
         kernel_launches=counts, rows_held_to_reference=checked,
         contract=CONTRACTS["scan"].__dict__, event_wall_s=event_s,
         rows_nasa=rows[0])


# The JAX package's scenario benchmark at width 1024 (benchmarks/run.py,
# its lines 598-690): 205 seeds x 5 points, two weeks, 3000 jobs a lane,
# the parameter ramps of its lines 668-678.
SCENARIO_WIDTH = 1024
SCENARIO_MAX_JOBS = 3000
SCENARIO_CHECK_WIDTH = 45        # kernel rows vs the plain step's


def scenario_points():
    return [SweepPoint("fb", capacity=96, label="FB(C=96)"),
            SweepPoint("fb", capacity=128, label="FB(C=128)"),
            SweepPoint("fb", capacity=160, label="FB(C=160)"),
            SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, label="FLB-NUB(B=25)"),
            SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, lease_seconds=1800.0,
                       label="FLB-NUB(L=30min)")]


def scenario_grid(width, n_points):
    W = max(1, int(round(width / n_points)))
    pbj = scenarioslib.PBJParams(
        nodes=128.0, utilization=np.linspace(0.35, 0.8, W),
        n_jobs=np.round(np.linspace(1800.0, 2900.0, W)),
        alpha=np.linspace(0.15, 0.7, W),
        burst_frac=np.linspace(0.06, 0.25, W),
        diurnal_depth=np.linspace(0.5, 0.95, W))
    ws = scenarioslib.WSParams(peak=np.round(np.linspace(32.0, 128.0, W)),
                               base_mean=np.linspace(8.0, 14.0, W),
                               surge_ratio=np.linspace(2.0, 6.0, W))
    return scenarioslib.ScenarioGrid(seeds=tuple(range(W)), pbj=pbj, ws=ws,
                                     duration=traces.TWO_WEEKS,
                                     max_jobs=SCENARIO_MAX_JOBS)


def hold_moments(synth, grid):
    """Every lane: job count exact, arrivals sorted and +inf padded,
    sizes powers of two in [1, nodes], the realized utilization within
    1e-3 of the lane's, the WS peak exact and the floor 1 VM."""
    p, q = grid.pbj, grid.ws
    for w in range(grid.n_lanes):
        n = int(synth.n_jobs[w])
        sub, size = synth.submit[w], synth.size[w][:n]
        rt, v = synth.runtime[w][:n], synth.ws_values[w]
        util = float((size * rt.astype(np.float64)).sum()) / (
            p.nodes * grid.duration)
        bad = [k for k, ok in (
            ("count", n == int(p.n_jobs[w])),
            ("sorted", bool(np.all(np.diff(sub[:n]) >= 0))),
            ("padding", bool(np.all(np.isinf(sub[n:])))),
            ("sizes", bool(np.all((size >= 1) & (size <= p.nodes))
                           and np.all(np.log2(size) ==
                                      np.round(np.log2(size))))),
            ("utilization", abs(util - float(np.float32(
                p.utilization[w]))) <= 1e-3),
            ("peak", float(v.max()) == float(q.peak[w])),
            ("floor", float(v.min()) >= 1.0)) if not ok]
        if bad:
            raise AssertionError(f"scenario lane {w}: {bad} (util {util})")


def synth_close(want, got, rtol=1e-5):
    """Two syntheses of one grid from the same (CPU) draws, made on
    different devices: counts and the padding exact, submit and runtime
    within ``rtol`` (the devices' float32 sin / log may differ in the
    last bit), sizes exact per group of arrivals within ``rtol`` of each
    other, WS demands within 1 VM everywhere, equal at >= 99.9 % of the
    steps, peak exact. Returns how many values differ at all."""
    if not np.array_equal(got.n_jobs, want.n_jobs):
        raise AssertionError("synthesis cuda vs cpu: n_jobs differ")
    diff = dict(submit=0, size=0, runtime=0, ws_values=0)
    for w in range(len(want.n_jobs)):
        n = int(want.n_jobs[w])
        sub_r, sz_r, rt_r = (x[w] for x in (want.submit, want.size,
                                            want.runtime))
        sub_p, sz_p, rt_p = (x[w] for x in (got.submit, got.size,
                                            got.runtime))
        bad = []
        if not (np.allclose(sub_p[:n], sub_r[:n], rtol=rtol, atol=0)
                and np.all(np.isinf(sub_p[n:])) and np.all(sz_p[n:] == 0)
                and np.all(rt_p[n:] == 0)):
            bad.append("submit")
        brk = np.nonzero(np.diff(sub_r[:n]) > rtol * sub_r[1:n])[0] + 1
        for a, b in zip(np.r_[0, brk], np.r_[brk, n]):
            pr = sorted(zip(sz_r[a:b], rt_r[a:b]))
            pp = sorted(zip(sz_p[a:b], rt_p[a:b]))
            if [x for x, _ in pr] != [x for x, _ in pp]:
                bad.append(f"sizes {a}:{b}")
            elif not np.allclose([r for _, r in pp], [r for _, r in pr],
                                 rtol=rtol, atol=0):
                bad.append(f"runtime {a}:{b}")
        v_r, v_p = want.ws_values[w], got.ws_values[w]
        if not (np.abs(v_p - v_r).max() <= 1.0
                and np.mean(v_p == v_r) >= 0.999 and v_p.max() == v_r.max()):
            bad.append("ws_values")
        if bad:
            raise AssertionError(f"synthesis cuda vs cpu, lane {w}: {bad}")
        diff["submit"] += int((sub_p[:n] != sub_r[:n]).sum())
        diff["size"] += int((sz_p[:n] != sz_r[:n]).sum())
        diff["runtime"] += int((rt_p[:n] != rt_r[:n]).sum())
        diff["ws_values"] += int((v_p != v_r).sum())
    return diff


def scenarios_phase(device, smi):
    """A generated scenario batch at width 1024 through
    run_sweep_workloads on the card: one round-step launch per policy
    over 615 FB and 410 FLB-NUB lanes; the lanes' moments, determinism,
    the card's synthesis against the CPU's, every row of the two launches
    against the plain step's on the same batch, sampled lanes against
    the event engine under CONTRACTS["rounds"], and at width 45 the
    kernel's rows against the plain step's."""
    points = scenario_points()
    grid = scenario_grid(SCENARIO_WIDTH, len(points))
    W, horizon = grid.n_lanes, grid.duration
    t0 = time.perf_counter()
    synth = scenarioslib.synthesize(grid, device)
    synth_first_s = time.perf_counter() - t0
    again = scenarioslib.synthesize(grid, device)
    for f in ("submit", "size", "runtime", "n_jobs", "ws_values"):
        if not np.array_equal(getattr(synth, f), getattr(again, f)):
            raise AssertionError(f"synthesize is not deterministic: {f}")
    hold_moments(synth, grid)
    t0 = time.perf_counter()
    on_cpu = scenarioslib.synthesize(grid, "cpu")
    synth_cpu_s = time.perf_counter() - t0
    synth_diff = synth_close(on_cpu, synth)

    def run():
        return run_sweep_workloads(points, grid, mode="rounds",
                                   device=device)

    zero_counts()
    t0 = time.perf_counter()
    rows = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    steps = rsk.outer_steps()
    if counts["round_step"] != 2 or any(v for k, v in counts.items()
                                        if k != "round_step"):
        raise AssertionError(f"the scenario batch's launches: {counts}, "
                             f"expected 2 round_step runs")
    truncated = [r["system"] for rs in rows for r in rs if r["truncated"]]
    if truncated:
        raise AssertionError(f"scenario rows truncated: {truncated}")
    # The split (synth / pack / engine, each synchronized) and each
    # launch's device time (CUDA events) and its inputs for the bound.
    launches = []
    run_rounds = rsk.run_rounds

    def recorded(jobs, rises, wstab, prm, sc, win, **kw):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        out = run_rounds(jobs, rises, wstab, prm, sc, win, **kw)
        stop.record()
        launches.append(((jobs, rises, wstab, prm), sc, win, out, kw,
                         start, stop))
        return out

    recorded.launches = run_rounds.launches
    rsk.run_rounds = recorded
    try:
        split = wall_split(run, (("synth", scenarioslib, "synthesize"),
                                 ("pack", sweeplib, "_pack_scenarios_grids"),
                                 ("engine", roundslib, "rounds_grids")))
    finally:
        run_rounds.launches = rsk.run_rounds.launches
        rsk.run_rounds = run_rounds
    torch.cuda.synchronize()
    per_launch = []
    for inputs, sc0, win0, (sc_end, _, lane_steps), kw, start, stop in \
            launches:
        policy, spec = kw["policy"], kw["spec"]
        lane_rounds = int((sc_end[:, ROUNDS_SC] - sc0[:, ROUNDS_SC]).sum())
        with OpCount() as count:
            rsk.chunk_step_ref(*inputs, sc0, win0, policy=policy, spec=spec)
        ops = count.ops / (sc0.shape[0] * spec.compact_every)
        bound_ms, bound_by = run_bound(policy, inputs, sc0, win0, sc_end,
                                       spec, lane_rounds, ops)
        per_launch.append(dict(
            policy=policy, lanes=int(sc0.shape[0]),
            job_table=int(inputs[0].shape[-1]),
            rise_table=int(inputs[1].shape[-1]),
            fold_table=int(inputs[2].shape[-1]),
            input_mb=sum(x.numel() * x.element_size() for x in inputs) / 1e6,
            outer_steps=int(lane_steps.max()),
            outer_steps_min=int(lane_steps.min()), lane_rounds=lane_rounds,
            device_ms=start.elapsed_time(stop), bound_ms=bound_ms,
            bound_by=bound_by))
    # Every row of the two launches against the plain step's on the same
    # batch (synth equals the batch run() drew: synthesis is
    # deterministic, checked above).
    zero_counts()
    t0 = time.perf_counter()
    plain = sweeplib._sweep_rounds_generated(
        points, grid, ScanOptions(kernel="torch"), synth=synth,
        device=device)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_counts = read_counts()
    if any(plain_counts.values()):
        raise AssertionError(f"the plain step launched kernels: "
                             f"{plain_counts}")
    for w in range(W):
        rows_equal(rows[w], plain[w], INTEGRAL_RTOL[torch.float32],
                   f"scenarios width 1024 lane {w}")
    # Sampled lanes against the event engine (CONTRACTS["rounds"]).
    sample = sorted({0, W // 2, W - 1})
    t0 = time.perf_counter()
    event = run_sweep_workloads(points,
                                scenarioslib.sample_workloads(synth, sample),
                                horizon, mode="event", device=device)
    event_s = time.perf_counter() - t0
    violations = [f"lane {w} {v}" for j, w in enumerate(sample)
                  for i in range(len(points))
                  for v in CONTRACTS["rounds"].check_row(rows[w][i],
                                                         event[j][i])]
    if violations:
        raise AssertionError(f"scenario rounds contract: {violations}")
    # Width 45: the kernel's rows against the plain step's on the card.
    small = scenario_grid(SCENARIO_CHECK_WIDTH, len(points))
    walls = {}
    out = {}
    for name, opts in (("kernel", ScanOptions()),
                       ("plain", ScanOptions(kernel="torch"))):
        t0 = time.perf_counter()
        out[name] = run_sweep_workloads(points, small, mode="rounds",
                                        device=device, scan_options=opts)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    for w in range(small.n_lanes):
        rows_equal(out["kernel"][w], out["plain"][w],
                   INTEGRAL_RTOL[torch.float32], f"scenarios width 45 {w}")
    emit("scenarios", card=smi, width=W * len(points), seeds=W,
         points=len(points), horizon_days=horizon / DAY,
         max_jobs=grid.max_jobs, dtype="float32", wall_s=wall_s,
         synth_first_s=synth_first_s, wall_split=split,
         round_step_launches=counts["round_step"], outer_steps=steps,
         launches=per_launch,
         kernel_device_ms=sum(x["device_ms"] for x in per_launch),
         window_overflow_rows=sum(r["window_overflow"] > 0 for rs in rows
                                  for r in rs),
         deterministic=True, moments_ok=True,
         synth_cpu={"wall_s": synth_cpu_s, "values_differing": synth_diff,
                    "close": True},
         plain_width_1024={"wall_s": plain_s, "rows_equal": True,
                           "kernel_launches": plain_counts},
         window_overflow_at=[[w, points[i].label] for w in range(W)
                             for i in range(len(points))
                             if rows[w][i]["window_overflow"] > 0],
         sampled_lanes=sample,
         event_wall_s=event_s, contract=CONTRACTS["rounds"].__dict__,
         width_45={"lanes": small.n_lanes * len(points),
                   "kernel_wall_s": walls["kernel"],
                   "plain_wall_s": walls["plain"], "rows_equal": True},
         rows_lane0=rows[0])
    return dict(launches=counts["round_step"], outer_steps=steps,
                per_launch=per_launch)


# ------------------------------------------------ the serving slice (LM)

# gemma2-2b at full width: 26 layers (local window 4096 / global
# alternating), d 2304, 8 q heads / 4 kv heads of 256, vocab 256000.
LM_ARCH = "gemma2_2b"
LM_SEED = 0
# Kernel vs plain version on the same CUDA inputs, elementwise
# |got - want| <= atol + rtol * |want|, as (atol, rtol). float32: the
# kernels sum in another order than the plain einsums, over up to 8192
# keys; against a float64 version the plain one is off by about 1e-6 on
# unit-scale scores and 2.5e-5 on the softcap case (CPU check at S 4600).
# bfloat16: both compute in float32 and round the output once, so they
# can differ only where the two roundings fall on either side of a
# boundary: one bfloat16 ulp, at most 2^-7 of the value (two ulps fail).
KERNEL_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 1e-2)}
# The softcap case: q scaled so the scores (else about N(0, 1)) reach
# the cap of 50, about N(0, 40^2) before it. Without the cap the softmax
# is nearly one-hot; with it the few keys that saturate near 50 share
# it. The plain version without the cap must fail the tolerance there,
# so a kernel that skipped the cap would too.
CAP_Q_SCALE = 40.0
# Peak rates for the bound (H100 SXM data sheet, 700 W). Attention and
# the SSD scan run on the tensor cores: bfloat16 at the dense rate (989
# TFLOP/s), float32 as three TF32 products per float32 product at the
# dense TF32 rate (495 TFLOP/s), a third of that in counted work; their
# float32 cases also report the CUDA cores' float32 rate (67 TFLOP/s),
# the bound of the port's first kernels. Decode computes float32 on the
# CUDA cores.
CUDA_CORE_FLOPS = 67e12
TENSOR_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CORE_PEAK_FLOPS = {torch.float32: CUDA_CORE_FLOPS, torch.bfloat16: 989e12}
ATTN_SEQS = (8192, 4600)          # 4600: ragged (not a multiple of 64)
ATTN_WINDOWS = (4096, None)       # gemma2's local and global layers
DECODE_BATCH, DECODE_CACHE = 8, 8192
DECODE_POSITIONS = (1000, 4616, 6000, 8191)   # 4616: the generate phase's
DECODE_CAP_POS = 6000
# Serving: float32 weights and compute (the Replica default).
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 8192, 16
SERVE_PROMPTS = tuple(int(x) for x in np.linspace(500, 6000, 8))
# An admission's prefill logits, kernel path vs plain path, float32:
# logits are O(1) (unit-rms hidden state against a d^-1/2 embedding);
# 26 layers of float32 arithmetic summed in two orders differ by about
# 1e-5 (measured on one H100).
SERVE_TOL = 1e-4
# Generate: bfloat16 weights and compute, as the serving cells build them.
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 8, 4600, 32
# Per-step logits, kernel route vs plain route, bfloat16: the plain path
# rounds scores and probabilities to bfloat16 in every layer (the kernel
# keeps them in float32), so the routes drift apart by bf16 noise, about
# 0.1 on logits of unit scale on one H100. The greedy token must agree
# on at least GEN_MIN_AGREEMENT of the (row, step) pairs.
GEN_TOL = 0.25
GEN_MIN_AGREEMENT = 0.9

# The Mamba2 slice: mamba2-130m at full width (24 layers, d 768, 24 SSM
# heads of 64, state 128, vocab 50280), chunk 128.
SSM_ARCH = "mamba2_130m"
SSD_CHUNK = 128
# SSD kernel vs plain version, elementwise |got - want| <= atol + rtol *
# |want| as (atol, rtol). float32: the reference's own tolerance for its
# largest SSD case (tests/test_kernels.py); the kernel sums in another
# order (up to 7.4e-5 apart at batch 8, L 4096 on one H100). bfloat16 x
# / B / C: both compute y in float32 and round it once, so the float32
# atol (near y = 0 the two float32 sums differ by more than a bfloat16
# ulp of y) plus one bfloat16 ulp (rtol 2^-7 < 1e-2); the final state is
# float32 in both cases.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-2)}
SSD_STATE_TOL = (1e-4, 1e-4)
# (batch, L, nonzero start state, strongest decay); cases up to
# SSD_SEQ_MAX tokens are also held against the token-by-token ssd_ref.
SSD_CASES = ((1, 4096, False, False), (8, 4096, False, False),
             (1, 2048, True, False), (1, 2048, False, True),
             (1, 512, False, False))
SSD_SEQ_MAX = 512
# serve_mamba: prompts of 512-4096 tokens (multiples of the chunk). An
# admission's SSM states (float32, entries of O(10) after 24 layers)
# against a plain prefill's, elementwise atol + rtol * |want|: the SSD
# state tolerance, since the kernel and the plain scan sum in two orders.
SSM_PROMPTS = tuple(int(x) for x in np.linspace(512, 4096, 8))
# generate_mamba: bfloat16, batch 8, a 4096-token prefill.
GEN_SSM_BATCH, GEN_SSM_PROMPT = 8, 4096

# The MoE slice: granite-moe-3b at full width and depth (32 layers, d
# 1536, 24 q heads / 8 kv heads of 64, 40 experts top-8 of d_ff 512,
# vocab 49155), no window, no softcap. Its attention cases: prefill at S
# 4600, batch 1 (serve_moe's admissions) in both dtypes and batch 8
# (generate_moe's prefill) in bfloat16, and decode at the phase's
# positions; serve_moe and generate_moe as serve and generate.
MOE_ARCH = "granite_moe_3b"

# The last two model families, each at full width. whisper-base (6
# encoder and 6 decoder layers, d 512, 8 / 8 heads of 64, vocab 51865,
# 1500 frames), full depth: float32 serving of 8 requests of 64-416
# prompt tokens with the serving engine's frontend of zeros, and bfloat16
# generation at batch 8 over a 416-token prompt into the decoder's real
# 448-token context (arXiv:2212.04356). llama-3.2-vision-90b (d 8192, 64 /
# 8 heads of 128, d_ff 28672, vocab 128256, 1601 patches) at 2 of its 20
# periods: 10 layers, 8 self-attention and 2 cross-attention (9.6 B
# parameters, 19 GB in bfloat16; all 100 layers, 90 B, do not fit one 80
# GB card). jamba-1.5-large (d 8192, 64 / 8 heads of 128, 128 SSM heads
# of 128, state 128, 16 experts top-2) at one period of 8 layers with
# d_ff cut 24576 -> 3072 (8.7 B parameters; one period at full d_ff is
# 44.6 B, 89 GB in bfloat16): the cut falls on the MLPs, plain tensor
# code, so the kernels see the model's own shapes. The prompts keep the
# plain route's float32 + bfloat16 score tensors near 13 GB (8 x 64 x
# 2048^2 x 6 bytes at jamba's 2048).
WHISPER_ARCH = "whisper_base"
WHISPER_PROMPTS = tuple(int(x) for x in np.linspace(64, 416, 8))
WHISPER_CONTEXT = 448
GEN_WHISPER_PROMPT = WHISPER_CONTEXT - GEN_STEPS
VISION_ARCH, VISION_LAYERS, VISION_PROMPT = "llama32_vision_90b", 10, 1024
HYBRID_ARCH, HYBRID_D_FF, HYBRID_PROMPT = "jamba15_large_398b", 3072, 2048


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, dtype):
    """The kernel's output against the plain version's under
    ``KERNEL_TOL``."""
    return errors(got, want, *KERNEL_TOL[dtype])


def errors(got, want, atol, rtol):
    """Max abs and relative (Frobenius) error of ``got`` against
    ``want``, and whether every element lies within atol + rtol *
    |want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return dict(max_abs_err=float(d.max()),
                rel_err=float(d.norm() / w.norm()),
                within_tol=bool((d <= atol + rtol * w.abs()).all()),
                tol={"atol": atol, "rtol": rtol})


def attn_case(cfg, s, window, dtype, device, gen, q_scale=1.0, batch=1):
    """flash_attention_bkv vs flash_attention_ref at ``batch``, causal;
    q scaled by ``q_scale``."""
    h, kv, hd = (batch * cfg.n_heads, batch * cfg.n_kv_heads,
                 cfg.head_dim_)
    q, k, v = ((torch.randn(n, s, hd, generator=gen, device=device) * f)
               .to(dtype) for n, f in ((h, q_scale), (kv, 1.0), (kv, 1.0)))
    cap = cfg.attn_softcap

    def kernel():
        return fak.flash_attention_bkv(q, k, v, window=window, softcap=cap)

    def plain():
        return kref.flash_attention_ref(q, k, v, window=window, softcap=cap)

    got, want = kernel(), plain()
    check = compare(got, want, dtype)
    if q_scale != 1.0:
        check["no_cap_within_tol"] = compare(got, kref.flash_attention_ref(
            q, k, v, window=window), dtype)["within_tol"]
    # library: one SDPA call, softcap off (no PyTorch call computes the
    # softcapped function), model layout (b, heads, s, hd). With a window
    # SDPA takes an explicit mask, which rules out its flash backend: a
    # weaker yardstick than its is_causal time without one.
    ql, kl, vl = (x.reshape(batch, -1, s, hd) for x in (q, k, v))
    mask = None if window is None else \
        window_mask(s, window, device)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    ms, device_bound = queued_ms(kernel, 3)
    pairs = kcost.visible_pairs(s, window)
    flops, nbytes = kcost.attention_cost(q, k, window)
    bound_ms, bound_by = bound(nbytes, flops, TENSOR_PEAK_FLOPS[dtype])
    if dtype == torch.float32:
        core_ms = 1e3 * flops / CUDA_CORE_FLOPS
        check.update(cuda_core_bound_ms=core_ms,
                     cuda_core_bound_fraction=core_ms / ms)
    out = dict(arch=cfg.name, seq=s, window=window, dtype=str(dtype)[6:],
               batch=batch, heads=h // batch, kv_heads=kv // batch, head_dim=hd,
               softcap=cap, q_scale=q_scale, **check, ms=ms,
               ms_device_bound=device_bound, tflop_per_s=flops / ms / 1e9,
               bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 2)[0],
               library_ms=queued_ms(library, 3)[0],
               library="scaled_dot_product_attention(enable_gqa=True), "
                       "softcap off", bound_ms=bound_ms, bound_by=bound_by,
               bound_bytes=nbytes, bound_flops=flops, visible_pairs=pairs)
    del q, k, v, got, want, mask
    return out


def window_mask(s, window, device):
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    return (cols <= rows) & (cols > rows - window)


def decode_case(cfg, pos, window, dtype, device, gen, q_scale=1.0,
                cache=DECODE_CACHE):
    """flash_decode_bkv vs flash_decode_ref at batch 8 over a ``cache``
    of keys; q scaled by ``q_scale``."""
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    bkv = DECODE_BATCH * kv
    q = (torch.randn(bkv, g, hd, generator=gen, device=device)
         * q_scale).to(dtype)
    k, v = (torch.randn(bkv, cache, hd, generator=gen,
                        device=device).to(dtype) for _ in range(2))
    at = torch.tensor(pos, dtype=torch.int32, device=device)
    cap = cfg.attn_softcap

    def kernel():
        return fdk.flash_decode_bkv(q, k, v, at, window=window, softcap=cap)

    def plain():
        return kref.flash_decode_ref(q, k, v, at, window=window, softcap=cap)

    got, want = kernel(), plain()
    check = compare(got, want, dtype)
    if q_scale != 1.0:
        check["no_cap_within_tol"] = compare(got, kref.flash_decode_ref(
            q, k, v, at, window=window), dtype)["within_tol"]
    cols = torch.arange(cache, device=device)
    valid = cols <= pos
    if window is not None:
        valid &= cols > pos - window
    ql = q.reshape(DECODE_BATCH, kv * g, 1, hd)
    kl = k.reshape(DECODE_BATCH, kv, cache, hd)
    vl = v.reshape(DECODE_BATCH, kv, cache, hd)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=valid[None, :], enable_gqa=True)

    ms, device_bound = queued_ms(kernel, 20)
    n_vis = int(valid.sum())
    flops, nbytes = kcost.decode_cost(q, k, n_vis)
    bound_ms, bound_by = bound(nbytes, flops, CORE_PEAK_FLOPS[dtype])
    out = dict(arch=cfg.name, pos=pos, window=window, dtype=str(dtype)[6:],
               batch=DECODE_BATCH, kv_heads=kv, group=g, head_dim=hd,
               cache=cache, softcap=cap, q_scale=q_scale, **check,
               ms=ms, ms_device_bound=device_bound,
               gb_per_s=nbytes / ms / 1e6, bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 5)[0],
               library_ms=queued_ms(library, 20)[0],
               library="scaled_dot_product_attention(enable_gqa=True, "
                       "attn_mask), softcap off", bound_ms=bound_ms,
               bound_by=bound_by, bound_bytes=nbytes, bound_flops=flops,
               visible_keys=n_vis)
    del q, k, v, got, want
    return out


def check_cases(phase, cases):
    for c in cases:
        emit(phase, **c)
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"{phase}: kernel differs from its plain "
                             f"version beyond tolerance: {bad}")
    blind = [c for c in cases if c.get("no_cap_within_tol")]
    if blind:
        raise AssertionError(f"{phase}: the softcap case does not tell a "
                             f"capped from an uncapped result: {blind}")


def zero_counts():
    rsk.run_rounds.launches = 0
    rsk.zero_outer_steps()
    rsk.chunk_step.launches = 0
    fak.flash_attention_bkv.launches = 0
    fdk.flash_decode_bkv.launches = 0
    ssk.ssd_scan_bh.launches = 0
    jsk.simulate_kernel.launches = 0


def read_counts():
    """Launches of each kernel since ``zero_counts``: ``round_step`` the
    engine's one-launch runs, ``round_step_chunk`` the one-step entry."""
    return {"round_step": rsk.run_rounds.launches,
            "round_step_chunk": rsk.chunk_step.launches,
            "flash_attention": fak.flash_attention_bkv.launches,
            "flash_decode": fdk.flash_decode_bkv.launches,
            "ssd_scan": ssk.ssd_scan_bh.launches,
            "jaxsim": jsk.simulate_kernel.launches}


# The stages of a rounds sweep that wall_split times: the host pack of
# the traces into tensors on the card, the lanes' startup (their tables,
# the kernel's stacked inputs and the t = 0 round) and the kernel.
SPLIT_STAGES = (("pack", sweeplib, "_pack_rounds"),
                ("startup", roundslib, "_lane_ctx"),
                ("startup", roundslib, "_startup"),
                ("startup", rsk, "lane_inputs"),
                ("kernel", rsk, "run_rounds"))


def wall_split(fn, stages=SPLIT_STAGES):
    """Where one call of ``fn`` (a sweep or the headline queries) spends
    its wall: each stage of ``stages`` is wrapped with a synchronize on
    both sides and its host wall summed; ``other_s`` is the rest (DCS /
    EC2 rows, row assembly, copies to the host). The synchronizes take
    away any overlap of host and device, so this is a call of its own,
    beside the unwrapped wall."""
    spent = {stage: 0.0 for stage, _, _ in stages}
    saved = []

    def wrap(stage, orig):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t0
            return out
        # run_rounds counts into the attribute its module name holds
        if hasattr(orig, "launches"):
            timed.launches = orig.launches
        return timed

    for stage, module, name in stages:
        orig = getattr(module, name)
        saved.append((module, name, orig))
        setattr(module, name, wrap(stage, orig))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for module, name, orig in saved:
            if hasattr(orig, "launches"):
                orig.launches = getattr(module, name).launches
            setattr(module, name, orig)
    return dict(wall_s=wall, **{f"{k}_s": v for k, v in spent.items()},
                other_s=wall - sum(spent.values()))


@contextmanager
def marked_profile():
    """A ``torch.profiler`` trace of host and device whose work is led by
    ``PROFILE_MARKS`` short spin kernels, the marks. On an H100 a trace
    loses the device records of its first few kernels, the more the
    longer its process has run: a count of records at its head, not a
    span of time (``tools/profiler_record_loss.py`` shows it). The marks
    take that loss: while a trace keeps one mark, it kept every record
    after it. ``device_kernels`` leaves them out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKS):
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
        yield prof
        torch.cuda.synchronize()


def device_kernels(prof):
    """The device kernels of a ``marked_profile`` trace, its marks left
    out, and how many marks the trace lost: ``(events, lost)``. With
    ``lost < PROFILE_MARKS`` every record of the work was kept."""
    from torch.autograd import DeviceType
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    kept = sum(ev.count for ev in events if "spin_kernel" in ev.key)
    return ([ev for ev in events if "spin_kernel" not in ev.key],
            PROFILE_MARKS - kept)


def breakdown(fn, sum_of=None, tries=5):
    """Where one call of ``fn`` spends its time: its host wall (host
    clock around the call and a synchronize, after a warm-up call), the
    device time of all its kernels from a ``marked_profile`` trace of a
    second call (None when the trace holds none), the busy share
    device / wall, the five kernels with the most device time, and for
    each ``key: name part`` of ``sum_of`` the device ms of the kernels
    whose name holds that part, under ``key``. A trace that lost every
    mark is taken again, up to ``tries`` times; ``marks_lost`` is the last
    one's count (at ``PROFILE_MARKS`` the device times may be short)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    for _ in range(tries):
        with marked_profile() as prof:
            fn()
        events, lost = device_kernels(prof)
        if lost < PROFILE_MARKS:
            break
    per_kernel = {}
    for ev in events:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            # kernels whose names share the first 80 characters add up
            key = ev.key[:80]
            per_kernel[key] = per_kernel.get(key, 0.0) + us / 1e3
    device_ms = sum(per_kernel.values()) or None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                top_kernels_ms=top, marks_lost=lost,
                **{key: sum(ms for name, ms in per_kernel.items()
                            if part in name)
                   for key, part in (sum_of or {}).items()})


def kernel_launches(fn, part, calls=3, tries=10):
    """Device kernels whose name holds ``part`` per call of ``fn``, from a
    ``marked_profile`` trace of ``calls`` calls, and the marks that trace
    lost: ``(per_call, marks_lost)``. A trace counts only if it
    kept a mark and ``calls`` divides its count (every call launches the
    same kernels); any other is taken again, up to ``tries`` times; then
    the count was not measured, and this raises."""
    seen = []
    for _ in range(tries):
        with marked_profile() as prof:
            for _ in range(calls):
                fn()
        events, lost = device_kernels(prof)
        n = sum(ev.count for ev in events if part in ev.key)
        if lost < PROFILE_MARKS and n % calls == 0:
            return n / calls, lost
        seen.append((n, lost))
    raise AssertionError(f"{tries} profiler traces of {calls} calls lost "
                         f"device records ((kernels whose name holds "
                         f"{part!r}, marks lost of {PROFILE_MARKS}) per "
                         f"trace: {seen}): the launches were not counted")


# The prefill profiles' device ms of the model kernels, by name part.
PREFILL_KERNELS = {"flash_attention_ms": "flash_fwd", "ssd_scan_ms": "ssd_"}


def ssm_states(cache):
    """The Mamba layers' SSM states of a cache (none for attention)."""
    return {name: layer["state"].clone() for name, layer in cache.items()
            if "state" in layer}


def serve_phase(cfg, device, phase, prompts, max_len, kernel):
    """The serving path at full width: AutoscaledService of Replicas that
    share one float32 model, one request per prompt length; ``kernel``
    launches once per layer of ``cfg.n_layers`` (a vlm / audio model:
    the decoder's) in each admission's prefill. Each admission's batch
    (with the engine's frontend, where it has one) is kept for the plain
    prefill it is held against."""
    model = Model(cfg, device, compute_dtype=torch.float32).init(LM_SEED)
    prefills = []
    prefill = model.prefill

    def recording_prefill(batch, cache):
        t0 = time.perf_counter()
        logits, cache = prefill(batch, cache)
        torch.cuda.synchronize()
        prefills.append((batch, logits, ssm_states(cache),
                         time.perf_counter() - t0))
        return logits, cache

    model.prefill = recording_prefill
    rng = np.random.default_rng(LM_SEED)
    requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                        .astype(np.int32), max_new_tokens=SERVE_NEW)
                for i, n in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    svc = AutoscaledService(cfg, device, slots_per_replica=SERVE_SLOTS,
                            max_len=max_len, params=model)
    for r in requests:
        svc.submit(r, now=0.0)
    trace = []
    for tick in range(4 * SERVE_NEW):
        svc.tick(now=float(tick))
        trace.append(len(svc.replicas))
        if not svc.queue and all(r.n_active == 0 for r in svc.replicas):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del model.prefill
    if len(svc.completed) != len(requests):
        raise AssertionError(f"{phase}: {len(svc.completed)} of "
                             f"{len(requests)} requests completed")
    if len(prefills) != len(requests) or any(
            n != (cfg.n_layers * len(prefills) if k == kernel else 0)
            for k, n in counts.items()):
        raise AssertionError(f"{phase}: {counts} launches for "
                             f"{len(prefills)} admissions")
    tokens = sum(len(r.output) for r in svc.completed)
    replicas = max(trace)
    del svc
    torch.cuda.empty_cache()
    # Each admission's logits (and SSM states) against a plain prefill of
    # its prompt.
    plain = model.with_impl("torch")
    errs, state_errs = [], []
    for batch, logits, states, _ in prefills:
        cache = plain.init_cache(1, batch["tokens"].shape[1],
                                 dtype=torch.float32)
        want, cache = plain.prefill(batch, cache)
        errs.append(float((logits - want).abs().max()))
        want_states = ssm_states(cache)
        state_errs += [errors(states[k], want_states[k], *SSD_STATE_TOL)
                       for k in states]
        del cache, want
    # Where a serving step's time goes: the longest admission's prefill
    # through the kernels, and one decode step of a full replica (4 slots
    # at their own positions).
    batch = prefills[-1][0]
    prefill_profile = breakdown(lambda: model.prefill(
        batch, model.init_cache(1, batch["tokens"].shape[1],
                                dtype=torch.float32)),
        sum_of=PREFILL_KERNELS)
    cache = model.init_cache(SERVE_SLOTS, max_len, dtype=torch.float32)
    slot_pos = torch.as_tensor(prompts[-SERVE_SLOTS:], device=device)
    slot_tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.long, device=device)
    step_profile = breakdown(lambda: model.decode(slot_tok, cache, slot_pos))
    del cache
    out = dict(arch=cfg.name, dtype="float32", requests=len(requests),
               prompts=list(prompts), max_new_tokens=SERVE_NEW,
               slots_per_replica=SERVE_SLOTS, max_len=max_len,
               completed=len(requests), tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, prefill_s=sum(p[3] for p in
                                                         prefills),
               prefill_s_each=[p[3] for p in prefills],
               max_replicas=replicas, instance_trace=trace,
               peak_memory_gb=peak / 1e9, launches=counts,
               prefill_max_abs_err=errs, tol=SERVE_TOL,
               prefill_profile=prefill_profile, step_profile=step_profile)
    if state_errs:
        out.update(state_max_abs_err=[e["max_abs_err"] for e in state_errs],
                   state_rel_err=[e["rel_err"] for e in state_errs],
                   state_tol=state_errs[0]["tol"])
    emit(phase, **out)
    if not max(errs) <= SERVE_TOL:
        raise AssertionError(f"{phase}: prefill logits differ from the "
                             f"plain path: {errs}")
    if not all(e["within_tol"] for e in state_errs):
        raise AssertionError(f"{phase}: SSM states differ from the plain "
                             f"path: {state_errs}")
    del model, plain, prefills
    torch.cuda.empty_cache()
    return out


class MoERouting:
    """Records the MoE layers' routing (``mlp._route``'s outputs, call by
    call) while ``record()`` is open and hands the same choices back, in
    the same order, while ``replay()`` is open. Recording keeps the
    tensors and reads nothing back, so it adds no host sync to the route
    it records; ``dropped()`` counts afterwards."""

    def __init__(self):
        self.log = []

    @contextmanager
    def _patched(self, fn):
        saved = mlpmod._route
        mlpmod._route = fn
        try:
            yield self
        finally:
            mlpmod._route = saved

    def record(self):
        route = mlpmod._route

        def recording(xl, router, cfg):
            out = route(xl, router, cfg)
            self.log.append(out)
            return out
        return self._patched(recording)

    def dropped(self):
        """(pairs dropped past capacity, pairs routed) over the recorded
        calls."""
        return (sum(int((~out[3]).sum()) for out in self.log),
                sum(out[3].numel() for out in self.log))

    def replay(self):
        return self._patched(lambda xl, router, cfg: self.log.pop(0))


def plain_logits(model, inputs, batch, cache_len, prompt, fed):
    """The plain route (impl="torch") teacher-forced on ``fed``: its
    prefill's last-token logits and each step's. ``inputs``: the
    prefill's batch (tokens, and a vlm / audio model's frontend)."""
    plain = model.with_impl("torch")
    cache = plain.init_cache(batch, cache_len, dtype=torch.bfloat16)
    lp0, cache = plain.prefill(inputs, cache)
    pos = torch.tensor(prompt, device=lp0.device)
    steps = []
    for tok in fed:
        lp, cache = plain.decode(tok[:, None], cache, pos)
        steps.append(lp[:, 0])
        pos = pos + 1
    del plain, cache
    torch.cuda.empty_cache()
    return lp0, steps


def logit_drift(a0, a, b0, b):
    """Logits ``a0`` (prefill) and ``a`` (steps) against ``b0`` / ``b``:
    (prefill max abs, step max abs, step mean abs, argmax agreement per
    step)."""
    errs, means, agree = [], [], []
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        errs.append(float(d.max()))
        means.append(float(d.mean()))
        agree.append(float((torch.argmax(x, -1) == torch.argmax(y, -1))
                           .float().mean()))
    return float((a0.float() - b0.float()).abs().max()), errs, means, agree


@contextmanager
def other_gemm_order():
    """cuBLAS at another reduction order: bfloat16 GEMMs reduce split-K
    partials in float32 (PyTorch lets them reduce in bfloat16 by
    default), and cuBLASLt serves them in place of cuBLAS (or the other
    way round) where this PyTorch can be told to. The same function, a
    different summation."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction
    pick = getattr(torch.backends.cuda, "preferred_blas_library", None)
    saved_lib = pick() if pick else None
    mm.allow_bf16_reduced_precision_reduction = not saved
    if pick:
        pick("cublas" if str(saved_lib).lower().endswith("cublaslt")
             else "cublaslt")
    try:
        yield dict(bf16_reduced_precision_reduction=not saved,
                   blas_library=str(pick()) if pick else None)
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved
        if pick:
            pick(saved_lib)


def generate_phase(cfg, device, phase, batch, prompt, cache_len, expected,
                   reduced=None):
    """The decode cell's path: bfloat16 weights and compute, a batch
    prefill of ``prompt`` tokens, then GEN_STEPS decode steps at one
    scalar position; the plain route replays the same tokens
    (teacher-forced). ``expected``: the launches of each kernel;
    ``reduced``: the cuts of ``cfg`` from the published config, reported.
    A vlm / audio model's prefill takes a frontend of standard-normal
    patch / frame embeddings from a seeded generator (the serving
    engine's zeros would make every cross-attention sublayer add 0).

    MoE models: the plain route also replays the kernel route's routing
    choices, and the limits hold on that comparison. bfloat16 noise
    between the routes (the plain route rounds scores and probabilities)
    moves near-tied router choices, and a moved choice changes a token's
    output by a whole expert's share: with free routing the routes drift
    apart by more than the kernels do (granite-moe-3b on one H100: 0.25–
    0.30 free, 0.0625 shared, 0.0 kernel route against itself). The
    free-routing drift is reported and its argmax agreement held, and so
    is the plain route's drift from itself at another GEMM summation
    order (``other_gemm_order``), the witness that such a drift comes
    from the arithmetic alone."""
    model = Model(cfg, device, compute_dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16).init(LM_SEED)
    moe = any(sp.mlp == MOE for sp in model.pattern)
    routing = MoERouting()
    rng = np.random.default_rng(LM_SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt)),
                           device=device)
    inputs = {"tokens": toks}
    if cfg.family in FRONTEND_FAMILIES:
        inputs["frontend"] = torch.randn(
            batch, cfg.frontend_len, cfg.d_model, device=device,
            generator=torch.Generator(device=device).manual_seed(LM_SEED))
    zero_counts()
    with routing.record() if moe else nullcontext():
        t0 = time.perf_counter()
        cache = model.init_cache(batch, cache_len, dtype=torch.bfloat16)
        lg0, cache = model.prefill(inputs, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pos = torch.tensor(prompt, device=device)
        nxt = torch.argmax(lg0[:, -1], dim=-1)
        fed, logits = [], []
        t1 = time.perf_counter()
        for _ in range(GEN_STEPS):
            fed.append(nxt)
            lg, cache = model.decode(nxt[:, None], cache, pos)
            logits.append(lg[:, 0])
            nxt = torch.argmax(lg[:, 0], dim=-1)
            pos = pos + 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
    counts = read_counts()
    if any(counts[k] != expected.get(k, 0) for k in counts):
        raise AssertionError(f"{phase}: launches {counts}, expected "
                             f"{expected}")
    step_profile = breakdown(lambda: model.decode(nxt[:, None], cache, pos),
                             sum_of={"flash_decode_ms": "decode_"})
    del cache
    torch.cuda.empty_cache()
    prefill_profile = breakdown(lambda: model.prefill(
        inputs, model.init_cache(batch, cache_len, dtype=torch.bfloat16)),
        sum_of=PREFILL_KERNELS)
    torch.cuda.empty_cache()
    moe_out = {}
    args = (model, inputs, batch, cache_len, prompt, fed)
    if moe:
        dropped, routed = routing.dropped()
        free = plain_logits(*args)
        with other_gemm_order() as order:
            other = plain_logits(*args)
        with routing.replay():
            shared = plain_logits(*args)
        if routing.log:
            raise AssertionError(f"{phase}: {len(routing.log)} recorded "
                                 f"routing calls were not replayed")
        prefill_err, errs, means, agree = logit_drift(lg0, logits, *shared)
        f = logit_drift(lg0, logits, *free)
        w = logit_drift(*free, *other)
        moe_out = dict(routing="shared", dropped_pairs=dropped,
                       routed_pairs=routed,
                       free_prefill_max_abs_err=f[0],
                       free_step_max_abs_err=max(f[1]),
                       free_step_mean_abs_err=max(f[2]),
                       free_argmax_agreement=sum(f[3]) / len(f[3]),
                       plain_vs_other_order=dict(
                           order, prefill_max_abs_err=w[0],
                           step_max_abs_err=max(w[1]),
                           step_mean_abs_err=max(w[2]),
                           argmax_agreement=sum(w[3]) / len(w[3])))
    else:
        prefill_err, errs, means, agree = logit_drift(
            lg0, logits, *plain_logits(*args))
    out = dict(arch=cfg.name, dtype="bfloat16", batch=batch,
               prompt=prompt, steps=GEN_STEPS, cache=cache_len,
               reduced=reduced, layers=cfg.n_layers,
               frontend=list(inputs["frontend"].shape)
               if "frontend" in inputs else None,
               prefill_s=prefill_s, decode_s=decode_s,
               decode_ms_per_step=1e3 * decode_s / GEN_STEPS,
               tokens_per_s=batch * GEN_STEPS / decode_s,
               launches=counts,
               prefill_flash_attention_device_ms=prefill_profile[
                   "flash_attention_ms"],
               prefill_ssd_scan_device_ms=prefill_profile["ssd_scan_ms"],
               step_flash_decode_device_ms=step_profile["flash_decode_ms"],
               prefill_max_abs_err=prefill_err,
               step_max_abs_err=max(errs), step_mean_abs_err=max(means),
               step_max_abs_errs=errs,
               logit_max_abs=max(float(x.float().abs().max())
                                 for x in [lg0] + logits),
               argmax_agreement=sum(agree) / len(agree), tol=GEN_TOL,
               min_argmax_agreement=GEN_MIN_AGREEMENT, **moe_out,
               prefill_profile=prefill_profile, step_profile=step_profile)
    emit(phase, **out)
    if not max(errs + [prefill_err]) <= GEN_TOL:
        raise AssertionError(f"{phase}: logits differ from the plain "
                             f"route beyond {GEN_TOL}: {errs}")
    for key in ("argmax_agreement", "free_argmax_agreement"):
        if key in out and not out[key] >= GEN_MIN_AGREEMENT:
            raise AssertionError(f"{phase}: {key} {out[key]} below "
                                 f"{GEN_MIN_AGREEMENT}")
    del model
    torch.cuda.empty_cache()
    return out


def ssd_case(cfg, batch, seq, dtype, device, gen, with_s0=False,
             strong_decay=False, sequential=False, via_ops=False):
    """ssd_scan_bh vs ssd_scan_bh_ref at the model's heads, head dim and
    state, inputs scaled as the reference's tests scale them; with
    ``sequential``, both also against the token-by-token ssd_ref. With
    ``via_ops``, the inputs are drawn in the model's layout with one B / C
    group, as a Mamba2 layer hands them to ``ops.ssd``, and ops.ssd's
    output (the fold, each head's copy of B / C, then the kernel) is what
    is held against the plain version; the kernel alone is timed on the
    folded inputs, ops.ssd as a whole beside it."""
    _, nh, n = ssm_dims(cfg)
    p, bh, q = cfg.ssm_head_dim, batch * nh, SSD_CHUNK

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    if via_ops:
        model_in = ((0.5 * randn(batch, seq, nh, p)).to(dtype),
                    -torch.nn.functional.softplus(randn(batch, seq, nh)),
                    *((0.3 * randn(batch, seq, 1, n)).to(dtype)
                      for _ in range(2)),
                    0.3 * randn(batch, nh, p, n) if with_s0 else None)
        x, a, B, C, s0 = kops.fold_ssd(*model_in)
    else:
        x = (0.5 * randn(bh, seq, p)).to(dtype)
        if strong_decay:
            # dt·A with A = -16 (A_log = log 16, the last head) and dt in
            # [0.5, 1.5): the upper triangle's exponents overflow to inf.
            a = -16.0 * (0.5 + torch.rand(bh, seq, generator=gen,
                                          device=device))
        else:
            a = -torch.nn.functional.softplus(randn(bh, seq))
        B, C = ((0.3 * randn(bh, seq, n)).to(dtype) for _ in range(2))
        s0 = 0.3 * randn(bh, p, n) if with_s0 else None

    def kernel():
        return ssk.ssd_scan_bh(x, a, B, C, s0=s0, chunk=q)

    def plain():
        return kref.ssd_scan_bh_ref(x, a, B, C, s0=s0, chunk=q)

    def model_path():
        return kops.ssd(*model_in[:4], init_state=model_in[4], chunk=q)

    if via_ops:
        y, sT = model_path()
        y, sT = y.permute(0, 2, 1, 3).reshape(bh, seq, p), sT.reshape(bh, p, n)
    else:
        y, sT = kernel()
    want_y, want_s = plain()
    check = errors(y, want_y, *SSD_TOL[dtype])
    state = errors(sT, want_s, *SSD_STATE_TOL)
    check.update(state_max_abs_err=state["max_abs_err"],
                 state_rel_err=state["rel_err"], state_tol=state["tol"])
    check["within_tol"] &= state["within_tol"]
    if sequential:
        seq_y, seq_s = kref.ssd_ref(x, a, B, C, s0)
        for got, want, tol, key in ((y, seq_y, SSD_TOL[dtype], "seq"),
                                    (sT, seq_s, SSD_STATE_TOL, "seq_state")):
            e = errors(got, want, *tol)
            check[f"{key}_max_abs_err"] = e["max_abs_err"]
            check["within_tol"] &= e["within_tol"]
    ms, device_bound = queued_ms(kernel, 5)
    if s0 is None and seq > q:
        # What the chain costs: the same chunks, each a row of its own (no
        # wait, no hand-off read), against the chained call.
        xs, as_, Bs, Cs = (t.reshape(-1, q, *t.shape[2:])
                           for t in (x, a, B, C))
        unchained = queued_ms(
            lambda: ssk.ssd_scan_bh(xs, as_, Bs, Cs, chunk=q), 5)[0]
        check.update(unchained_ms=unchained, chain_ms=ms - unchained)
        del xs, as_, Bs, Cs
    # Per chunk: C·Bᵀ and (C·Bᵀ∘L)·x over the Q(Q+1)/2 pairs the mask
    # keeps, C·Sᵀ and (x∘w)ᵀ·B in full.
    flops, nbytes = kcost.ssd_cost(x, a, B, C, q, with_s0)
    e = x.element_size()
    bound_ms, bound_by = bound(nbytes, flops, TENSOR_PEAK_FLOPS[dtype])
    if dtype == torch.float32:
        core_ms = 1e3 * flops / CUDA_CORE_FLOPS
        check.update(cuda_core_bound_ms=core_ms,
                     cuda_core_bound_fraction=core_ms / ms)
    if via_ops:
        # ops.ssd: the fold's copies of B / C per head are written by it
        # and read by the kernel; its own inputs hold one group.
        e_in = model_in[2].numel() + model_in[3].numel()
        ops_bytes = nbytes - e * (B.numel() + C.numel() - e_in)
        check.update(ops_ms=queued_ms(model_path, 5)[0],
                     ops_bound_ms=bound(ops_bytes, flops,
                                        TENSOR_PEAK_FLOPS[dtype])[0],
                     ops_bound_bytes=ops_bytes,
                     bc_copy_bytes=e * (B.numel() + C.numel()), groups=1)
    launches, marks_lost = kernel_launches(kernel, "ssd_")
    out = dict(arch=cfg.name, batch=batch, seq=seq, heads=nh, head_dim=p,
               state=n, chunk=q, dtype=str(dtype)[6:], with_s0=with_s0,
               strong_decay=strong_decay, via_ops=via_ops,
               a_min=float(a.min()), **check,
               ms=ms, ms_device_bound=device_bound,
               kernel_launches_per_call=launches,
               profile_marks_lost=marks_lost, bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 2)[0], bound_ms=bound_ms,
               bound_by=bound_by, bound_bytes=nbytes, bound_flops=flops)
    del x, a, B, C, s0, y, sT, want_y, want_s
    if via_ops:
        del model_in
    if launches != 1:
        raise AssertionError(f"ssd_scan_bh made {launches} kernel launches "
                             f"a call, expected 1: {out}")
    return out


# ------------------------------------------------------ training on the card
#
# The trainer (repro_torch.train) runs the plain path under autograd, as
# the reference's trainer runs its XLA path: no kernel launches, which the
# phases check. gemma2-2b at full width and depth (26 layers, d 2304,
# vocab 256000), float32, AdamW, TrainJobConfig's defaults (batch 8,
# seq_len 128, lr 3e-4), no checkpoint directory (a full-width checkpoint
# is 42 GB of disk). TF32 is off (set before the serving phases), so the
# float32 products are float32.

TRAIN_STEPS = 12
# float32 step 0 against a float64 evaluation of the same weights and batch
TRAIN_F64_LOSS_RTOL = 1e-4
TRAIN_F64_GNORM_RTOL = 1e-3
TRAIN_REDUCED_ARCHS = ("smollm_135m", "gemma2_2b", "granite_moe_3b",
                       "mamba2_130m", "jamba15_large_398b",
                       "llama32_vision_90b", "whisper_base")
# the card's loss and gradients against the CPU's (the CPU tests' limits
# against the JAX package): loss rtol, and each gradient leaf within this
# share of its largest magnitude
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 5e-4
# the dry run's product count of a train_full step against the hand
# count corrected by the remat's tail and the score products
TRAIN_COUNT_RTOL = 0.01


def no_kernel_launched(phase):
    if any(read_counts().values()):
        raise AssertionError(f"{phase}: training launched a kernel: "
                             f"{read_counts()}")


def train_flops(model, tokens):
    """Model FLOPs of one training step: 6 per parameter and token
    (forward and backward; the tied embedding counts once, for the
    logits' product) plus 2 per block parameter and token for the remat
    forward. Attention's score products are left out (0.2 % at seq_len
    128)."""
    n = sum(p.numel() for p in model.parameters())
    blocks = sum(p.numel() for p in model.blocks.parameters())
    return 6 * n * tokens + 2 * blocks * tokens


def remat_tail_and_scores(model, batch, seq_len):
    """The two terms by which the hand count ``train_flops`` differs from
    the products the step runs: the products the remat does NOT redo
    (PyTorch's non-reentrant checkpoint stops its recompute at the last
    tensor the backward needs, so each period's last product, the last
    layer's w2, is not recomputed: 2 per parameter and token) and the
    attention's score products it leaves out (Q·Kᵀ and P·V over all s²
    pairs of the plain path, forward, recompute and twice in the
    backward)."""
    cfg = model.cfg
    last = model.blocks[f"l{len(model.pattern) - 1}"]
    tail = last.mlp["w2"].numel() if hasattr(last, "mlp") else 0
    tokens = batch * seq_len
    scores = 4 * 4 * batch * cfg.n_heads * seq_len ** 2 * cfg.head_dim_ \
        * cfg.n_layers
    return 2 * tail * tokens, scores


def step_split(job, step):
    """One call of ``step`` (a training step of ``job``) split by host
    clock into the loss's forward, the optimizer's update (each with a
    synchronize on both sides) and the rest: the backward (with the
    remat forward) and the gradient norm."""
    spent = {"forward_s": 0.0, "update_s": 0.0}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    optimizer = job.optimizer
    job.model.loss = timed(job.model.loss, "forward_s")
    job.optimizer = dataclasses.replace(
        optimizer, update=timed(optimizer.update, "update_s"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del job.model.loss
        job.optimizer = optimizer
    return dict(wall_s=wall, **spent,
                backward_s=wall - sum(spent.values()))


def train_full_phase(device, smi):
    cfg = get_config(LM_ARCH)
    jc = TrainJobConfig(arch=LM_ARCH, steps=TRAIN_STEPS, seed=LM_SEED)
    batch0 = make_source(cfg, jc.batch, jc.seq_len,
                         seed=jc.seed).batch_at(0)
    # The float64 evaluation: the same initial weights (Model.init draws
    # float32 normals and casts them) and the step-0 batch, before the
    # trainer's state exists.
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m64 = Model(cfg, device, impl="torch", compute_dtype=torch.float64,
                param_dtype=torch.float64).init(jc.seed).double()
    m64.requires_grad_(True)
    loss64 = m64.loss(batch0)
    loss64.backward()
    gnorm64 = float(torch.sqrt(sum(torch.sum(p.grad * p.grad)
                                   for p in m64.parameters())))
    loss64 = float(loss64.detach())
    for p in m64.parameters():
        p.grad = None
    m64.requires_grad_(False)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    f64_peak = torch.cuda.max_memory_allocated()
    # The trainer: its initial weights equal the float64 model's, bit for
    # bit; then the float64 model is freed.
    job = TrainJob(cfg, jc, device)
    job.initialize()
    same_init = all(torch.equal(p.double(), q) for p, q in
                    zip(job.model.parameters(), m64.parameters()))
    del m64
    torch.cuda.empty_cache()
    if not same_init:
        raise AssertionError("train_full: the trainer's initial weights "
                             "differ from the float64 model's")
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for k in range(TRAIN_STEPS):
        job.jc.steps = k + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    no_kernel_launched("train_full")
    hist, gnorms = list(job.history), list(job.grad_norms)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(hist)) or \
            not all(np.isfinite(gnorms)):
        raise AssertionError(f"train_full: losses {hist}, grad norms "
                             f"{gnorms}")
    loss_rel = abs(hist[0] - loss64) / abs(loss64)
    gnorm_rel = abs(gnorms[0] - gnorm64) / gnorm64
    if loss_rel > TRAIN_F64_LOSS_RTOL or gnorm_rel > TRAIN_F64_GNORM_RTOL:
        raise AssertionError(
            f"train_full: float32 step 0 (loss {hist[0]}, grad norm "
            f"{gnorms[0]}) against float64 (loss {loss64}, grad "
            f"norm {gnorm64}): relative {loss_rel}, {gnorm_rel}")
    first4, last4 = float(np.mean(hist[:4])), float(np.mean(hist[-4:]))
    if not last4 < first4:
        raise AssertionError(f"train_full: the loss did not fall: {hist}")
    tokens = jc.batch * jc.seq_len
    median_s = float(np.median(step_s[1:]))
    flops = train_flops(job.model, tokens)

    def one_more_step():
        job.jc.steps += 1
        job.run()

    prof = breakdown(one_more_step)
    split = step_split(job, one_more_step)
    # The dry run's count of the same step (launch.cells.analytic_cost on
    # the meta device: loss, gradients and the AdamW update) beside the
    # hand count; its products held to the hand count corrected by the
    # remat's early stop and the score products.
    counted = cells.analytic_cost(LM_ARCH, "train_4k", torch.float32,
                                  global_batch=jc.batch,
                                  seq_len=jc.seq_len)
    tail, scores = remat_tail_and_scores(job.model, jc.batch, jc.seq_len)
    expected_products = flops - tail + scores
    products_rel = counted["products"] / expected_products - 1.0
    if abs(products_rel) > TRAIN_COUNT_RTOL:
        raise AssertionError(
            f"train_full: the dry run counts {counted['products']} product "
            f"FLOPs a step, the hand count {flops} less the remat's "
            f"untouched tail {tail} plus the scores {scores} is "
            f"{expected_products}: relative {products_rel}")
    emit("train_full", card=smi, arch=LM_ARCH,
         params=sum(p.numel() for p in job.model.parameters()),
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         dtype="float32", optimizer=cfg.optimizer, batch=jc.batch,
         seq_len=jc.seq_len, lr=jc.lr, steps=TRAIN_STEPS, losses=hist,
         grad_norms=gnorms, first4_mean=first4, last4_mean=last4,
         f64_loss=loss64, f64_grad_norm=gnorm64, f64_loss_rel=loss_rel,
         f64_grad_norm_rel=gnorm_rel, f64_s=f64_s,
         f64_peak_gb=f64_peak / 1e9,
         tol={"loss_rtol": TRAIN_F64_LOSS_RTOL,
              "grad_norm_rtol": TRAIN_F64_GNORM_RTOL},
         step_s=step_s, first_step_s=step_s[0], median_step_s=median_s,
         tokens_per_s=tokens / median_s, peak_memory_gb=peak / 1e9,
         model_tflop_per_step=flops / 1e12,
         analytic_tflop_per_step=counted["flops"] / 1e12,
         analytic_products_tflop=counted["products"] / 1e12,
         analytic_over_hand=counted["flops"] / flops,
         remat_tail_tflop=tail / 1e12, score_tflop=scores / 1e12,
         analytic_products_rel=products_rel,
         analytic_tol={"products_rtol": TRAIN_COUNT_RTOL},
         achieved_tflop_per_s=flops / median_s / 1e12,
         cuda_core_bound_s=flops / CUDA_CORE_FLOPS,
         profiled_step=prof, step_split=split,
         kernel_launches=read_counts())
    del job
    torch.cuda.empty_cache()
    return {"losses": hist, "peak_memory_gb": peak / 1e9,
            "median_step_s": median_s}


def loss_and_grads(model, batch):
    model.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()}


def train_reduced_phase(device, smi):
    """Each family's reduced config: Model.loss and every gradient on the
    card against the CPU's, the same seeded weights and batch."""
    zero_counts()
    rows = []
    for arch in TRAIN_REDUCED_ARCHS:
        cfg = reduced_config(get_config(arch))
        cpu = Model(cfg, "cpu", impl="torch",
                    compute_dtype=torch.float32).init(LM_SEED)
        card = Model(cfg, device, impl="torch", compute_dtype=torch.float32)
        card.load_state_dict(cpu.state_dict())
        batch = make_source(cfg, 2, 32, seed=LM_SEED).batch_at(0)
        want_loss, want = loss_and_grads(cpu, batch)
        got_loss, got = loss_and_grads(card, batch)
        worst = max((float((got[n] - w).abs().max())
                     / max(float(w.abs().max()), 1e-30), n)
                    for n, w in want.items())
        row = dict(arch=arch, loss_cpu=want_loss, loss_card=got_loss,
                   loss_rel=abs(got_loss - want_loss) / abs(want_loss),
                   worst_grad_rel=worst[0], worst_grad_leaf=worst[1],
                   grad_leaves=len(want))
        rows.append(row)
        if row["loss_rel"] > TRAIN_LOSS_RTOL or worst[0] > TRAIN_GRAD_TOL:
            raise AssertionError(f"train_reduced: the card's loss or "
                                 f"gradients differ from the CPU's: {row}")
    no_kernel_launched("train_reduced")
    emit("train_reduced", card=smi, rows=rows,
         tol={"loss_rtol": TRAIN_LOSS_RTOL,
              "grad_share_of_leaf_max": TRAIN_GRAD_TOL})


def train_resume_phase(device, smi, root):
    """The reference's worker-failure case on the card (reduced smollm):
    an uninterrupted 20-step run; a job killed after step 13 whose
    checkpoints past step 10 are lost; a new job that restores at 10 and
    finishes with the uninterrupted run's losses, bit for bit. Then
    preempt at step 8 and resume to 20."""
    cfg = reduced_config(get_config("smollm_135m"))
    mk = lambda d, steps, every=10: TrainJobConfig(
        arch="smollm_135m", steps=steps, batch=4, seq_len=32, lr=1e-3,
        checkpoint_dir=str(root / d), checkpoint_every=every)
    zero_counts()
    t0 = time.perf_counter()
    ref = TrainJob(cfg, mk("ref", 20), device)
    ref.run()
    a = TrainJob(cfg, mk("worker", 13), device)
    a.run()
    for s in a.ckpt.all_steps():
        if s > 10:
            shutil.rmtree(root / "worker" / f"step_{s}")
    del a
    b = TrainJob(cfg, mk("worker", 20), device)
    b.initialize()
    restored_at = b.step
    result = b.run()
    wall_s = time.perf_counter() - t0
    diff = [x - y for x, y in zip(b.history, ref.history[10:])]
    if restored_at != 10 or not result["completed"] or \
            b.history != ref.history[10:20]:
        raise AssertionError(f"train_resume: restored at {restored_at}, "
                             f"resumed losses {b.history} vs "
                             f"{ref.history[10:20]}")
    same_params = all(torch.equal(p, q) for p, q in
                      zip(ref.model.parameters(), b.model.parameters()))
    if not same_params:
        raise AssertionError("train_resume: the resumed weights differ")
    # preempt → checkpoint → a new job resumes at the step it stopped
    p = TrainJob(cfg, mk("preempt", 8, every=5), device)
    p.run()
    p.checkpoint(block=True)
    q = TrainJob(cfg, mk("preempt", 20, every=5), device)
    q.initialize()
    resumed_at = q.step
    q.run()
    if resumed_at != 8 or q.step != 20:
        raise AssertionError(f"train_resume: preempted at 8, resumed at "
                             f"{resumed_at}, ended at {q.step}")
    no_kernel_launched("train_resume")
    emit("train_resume", card=smi, arch="smollm_135m (reduced)",
         restored_at=restored_at, losses_equal_bit_for_bit=True,
         loss_diffs=diff, weights_equal=same_params,
         uninterrupted=ref.history, resumed=b.history,
         preempt_resumed_at=resumed_at, preempt_final_step=q.step,
         wall_s=wall_s)


def live_preempt_and_resume(cloud, root):
    """tests/test_serving_and_bridge.py's live scenario (a reduced smollm
    TrainJob of 20 steps on 6 of 8 chips, five steps, a WS spike to 5
    that preempts it through a checkpoint, the spike receding, a lease
    tick, then quanta of five steps to completion); returns the payload
    and whether the preempt wrote a checkpoint."""
    cloud.submit_training(jid=1, arch="smollm_135m", chips=6, steps=20)
    cloud.run_quantum(steps=5)
    payload = cloud._live[1].payload
    cloud.preempt_for_ws(5)
    preempted = 1 not in cloud.pbj.running
    wrote = any((root / "job1").rglob("*"))
    at_preempt = payload.step
    cloud.set_ws_demand(1)
    cloud.lease_tick()
    for _ in range(6):
        if cloud.run_quantum(steps=5):
            break
    return payload, dict(preempted=preempted, checkpoint_written=wrote,
                         step_at_preempt=at_preempt, final_step=payload.step)


def live_train_phase(device, smi, root):
    """LiveCloud(capacity=8, mesh=device) with a live training job,
    preempted and resumed; its decision ledger equal to the same run's
    on the CPU, entry for entry."""
    zero_counts()
    t0 = time.perf_counter()
    card = LiveCloud(capacity=8, mesh=device,
                     checkpoint_root=str(root / "card"))
    payload, card_run = live_preempt_and_resume(card, root / "card")
    card_s = time.perf_counter() - t0
    no_kernel_launched("live_train")
    cpu = LiveCloud(capacity=8, mesh="cpu",
                    checkpoint_root=str(root / "cpu"))
    cpu_payload, cpu_run = live_preempt_and_resume(cpu, root / "cpu")
    ledger = [dataclasses.astuple(e) for e in card.ledger.entries]
    same = ledger == [dataclasses.astuple(e) for e in cpu.ledger.entries]
    if not (card_run["preempted"] and card_run["checkpoint_written"]
            and card_run["final_step"] == 20 and same
            and payload.device.type == "cuda"):
        raise AssertionError(f"live_train: {card_run}, ledger equal to the "
                             f"CPU's: {same}")
    emit("live_train", card=smi, **card_run, ledger_entries=len(ledger),
         ledger_equal_cpu=same, kills=card.ledger.kills(),
         losses=payload.history, cpu_losses=cpu_payload.history,
         host_wall_s=card_s)


# The dry run (launch/dryrun.py) against the card: a cell runs on the card
# when its forecast peak fits in this share of the card's memory; the
# forecast peak must lie within DRYRUN_PEAK_RTOL of the growth of
# max_memory_allocated over the cell; gemma2-2b's three LM cells also run
# at the largest batch in {1, 2, 4, ...} whose forecast fits.
DRYRUN_FIT = 0.9
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_CUT_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_KERNELS = ("flash_attention", "flash_decode", "ssd_scan")
# processes of the meta grid, one per architecture (none touches CUDA)
DRYRUN_WORKERS = 8


def dryrun_grid():
    """Every (arch, shape) cell through dryrun.run_cell on the meta
    device: ``dryrun --workers``, one process per architecture."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        return dryrun.main(["--workers", str(DRYRUN_WORKERS), "--out",
                            out])


def card_cell(arch, shape_name, device, smi, forecast, global_batch=None):
    """One cell on the card, built and run as the forecast ran it on
    meta (impl "cuda" for prefill and decode): the growth of
    max_memory_allocated over the cell (from before its first argument to
    the end of its first step) against the forecast peak, the kernels'
    launches in that step against the forecast's routes, a finite result
    of the forecast's shape, then the step's device time (time_calls),
    its model TFLOP/s and its share of the forecast's roofline bound."""
    cfg = get_config(arch)
    shape = dataclasses.replace(
        cfg.shapes()[shape_name],
        global_batch=global_batch or cfg.shapes()[shape_name].global_batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    cell = cells.build_cell(arch, shape_name, make_local_mesh(device),
                            global_batch=global_batch)
    model, step, args = cell.build()
    out = step(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in read_counts().items() if v}
    result = out[0] if shape.kind != "train" else out[2]["loss"]
    finite = bool(torch.isfinite(result.float()).all())
    got_shape = list(result.shape)
    del out, result
    ms, host_ms = time_calls(lambda: step(*args), 1 if first_s > 2 else 3)
    impl = model.impl
    del model, step, args, cell
    torch.cuda.empty_cache()
    want_launches = {k: v for k, v in forecast["kernel_launches"].items()}
    model_flops = hlo.model_flops_estimate(cfg, shape)
    roof = hlo.analyze(arch, shape_name, forecast, 1,
                       model_flops=model_flops)
    bound_s = max(roof.t_compute, roof.t_memory)
    rel = forecast["peak_bytes"] / peak - 1.0
    rec = dict(card=smi, arch=arch, shape=shape_name, kind=shape.kind,
               global_batch=shape.global_batch, seq_len=shape.seq_len,
               impl=impl, forecast_peak_gb=forecast["peak_bytes"] / 1e9,
               measured_peak_gb=peak / 1e9, peak_rel=rel,
               peak_tol=DRYRUN_PEAK_RTOL,
               memory_analysis=forecast["memory_analysis"],
               launches=launches, forecast_launches=want_launches,
               result_shape=got_shape, result_finite=finite,
               first_call_s=first_s, ms=ms, host_ms=host_ms,
               model_flops=model_flops,
               model_tflop_per_s=model_flops / ms / 1e9,
               forecast_flops=forecast["flops"],
               forecast_bytes=forecast["bytes"],
               bound_ms=1e3 * bound_s, bottleneck=roof.bottleneck,
               bound_fraction=1e3 * bound_s / ms)
    emit("dryrun_card", **rec)
    if abs(rel) > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dryrun {arch}/{shape_name} at batch "
                             f"{shape.global_batch}: forecast peak "
                             f"{forecast['peak_bytes']} against "
                             f"{peak} measured ({rel:+.3f})")
    if launches != want_launches:
        raise AssertionError(f"dryrun {arch}/{shape_name}: the card "
                             f"launched {launches}, the forecast's routes "
                             f"{want_launches}")
    if not finite or got_shape != forecast["result"]["shape"]:
        raise AssertionError(f"dryrun {arch}/{shape_name}: result "
                             f"{got_shape}, finite {finite}; forecast "
                             f"{forecast['result']}")
    return rec


def dryrun_phase(device, smi):
    """(a) The dry run's grid: all 40 cells at published width, depth
    and global batch on meta; no fail, and the skips are the configs'
    long_500k skips. (b) The forecast against the card: every cell whose
    forecast fits in DRYRUN_FIT of the card's memory, and gemma2-2b's
    LM cells cut to the largest batch whose forecast fits."""
    t0 = time.time()
    recs = dryrun_grid()
    grid_s = time.time() - t0
    for r in recs:
        line = {k: r.get(k) for k in ("arch", "shape", "status", "seconds",
                                      "reason", "error")}
        if r["status"] == "ok":
            line.update(hlo_flops=r["hlo_flops"], hlo_bytes=r["hlo_bytes"],
                        forecast_flops=r["forecast"]["flops"],
                        forecast_bytes=r["forecast"]["bytes"],
                        forecast_peak_gb=r["forecast"]["peak_bytes"] / 1e9,
                        bottleneck=r["bottleneck"],
                        fits_card=r["fits_card"],
                        kernel_launches=r["forecast"]["kernel_launches"])
        emit("dryrun_cell", **line)
    failed = [(r["arch"], r["shape"], r.get("error")) for r in recs
              if r["status"] == "fail"]
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skip"}
    want_skips = {(a, sh) for a in ARCH_IDS
                  for sh, spec in get_config(a).shapes().items()
                  if spec.skip}
    if failed or skipped != want_skips or len(recs) != 40:
        raise AssertionError(f"dryrun grid: failed {failed}; skipped "
                             f"{sorted(skipped)}, the configs skip "
                             f"{sorted(want_skips)}")
    total = torch.cuda.get_device_properties(device).total_memory
    room = DRYRUN_FIT * total
    runs = [(r["arch"], r["shape"], None,
             dict(r["forecast"], memory_analysis=r["memory_analysis"]))
            for r in recs
            if r["status"] == "ok" and r["forecast"]["peak_bytes"] <= room]
    meta = make_local_mesh("meta")
    cuts = {}
    for sh in DRYRUN_CUT_SHAPES:
        b, best = 1, None
        while True:
            f = cells.count_cell(cells.build_cell(LM_ARCH, sh, meta,
                                                  global_batch=b))
            if f["peak_bytes"] > room:
                break
            best = (b, f)
            b *= 2
        if best is None:
            raise AssertionError(f"dryrun: {LM_ARCH}/{sh} does not fit the "
                                 f"card at batch 1")
        cuts[sh] = best[0]
        runs.append((LM_ARCH, sh, best[0], best[1]))
    card = [card_cell(a, sh, device, smi, f, gb) for a, sh, gb, f in runs]
    emit("dryrun", card=smi, grid_s=grid_s, workers=DRYRUN_WORKERS,
         cells=len(recs), ok=sum(r["status"] == "ok" for r in recs),
         skip=len(skipped), fail=0,
         fits_card=[(r["arch"], r["shape"]) for r in recs
                    if r.get("fits_card")],
         card_memory_gb=total / 1e9, fit_share=DRYRUN_FIT,
         reduced={f"{LM_ARCH}/{sh}": f"global batch {b} (published "
                  f"{get_config(LM_ARCH).shapes()[sh].global_batch}): the "
                  f"largest power of 2 whose forecast fits"
                  for sh, b in cuts.items()},
         ran_on_card=[(c["arch"], c["shape"], c["global_batch"])
                      for c in card],
         max_abs_peak_rel=max(abs(c["peak_rel"]) for c in card),
         wall_s=time.time() - t0)
    return card


# The collectives gloo carries for CUDA tensors (PyTorch's documented
# backend table: broadcast, all_reduce, barrier); the int8 error-feedback
# all-reduce also needs send / recv for its ring (batch_isend_irecv).
GLOO_CUDA_OPS = {"broadcast", "all_reduce", "barrier"}
EF_ALLREDUCE_OPS = {"all_reduce", "send", "recv"}
SHARDED_DEVICES = ["cuda:0", "cuda:0"]
SHARDED_TRAIN = ("gemma2_2b", "granite_moe_3b")
SHARDED_STEPS = 3
SHARDED_FULL_STEPS = 3


@contextlib.contextmanager
def one_rank_layout():
    """A (1, 1) ``make_mesh`` layout of a one-rank nccl group on the card,
    torn down on leaving."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_train_full_phase(device, smi, plain):
    """gemma2-2b at full width and depth through the DTensor path on a
    (1, 1) layout: ``Model.init`` (a whole plain copy, then ``place_``),
    the per-rank layers, the vocabulary loss and the pinned gradients,
    ``SHARDED_FULL_STEPS`` steps at train_full's job. The losses must
    equal train_full's plain job's bit for bit; the peak memory of the
    set-up and of the steps (``max_memory_allocated``, as train_full
    reads it) is reported beside the plain job's."""
    cfg = get_config(LM_ARCH)
    jc = TrainJobConfig(arch=LM_ARCH, steps=SHARDED_FULL_STEPS,
                        seed=LM_SEED)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    zero_counts()
    with one_rank_layout() as layout:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        job = TrainJob(cfg, jc, layout)
        job.initialize()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        if type(job.model.embed).__name__ != "DTensor":
            raise AssertionError("sharded_train_full: the layout's weights "
                                 "are not DTensors")
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for k in range(SHARDED_FULL_STEPS):
            job.jc.steps = k + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job.run()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        hist = list(job.history)
        del job
    torch.cuda.empty_cache()
    no_kernel_launched("sharded_train_full")
    want = plain["losses"][:SHARDED_FULL_STEPS]
    if hist != want:
        raise AssertionError(f"sharded_train_full: losses on the (1, 1) "
                             f"layout {hist} != the plain job's {want}")
    emit("sharded_train_full", card=smi, arch=LM_ARCH, layout=[1, 1],
         dtype="float32", batch=jc.batch, seq_len=jc.seq_len,
         steps=SHARDED_FULL_STEPS, losses=hist, equal_bit_for_bit=True,
         init_s=init_s, step_s=step_s, median_step_s=float(
             np.median(step_s[1:])),
         plain_median_step_s=plain["median_step_s"],
         allocated_before_gb=base / 1e9,
         init_peak_memory_gb=init_peak / 1e9,
         step_peak_memory_gb=peak / 1e9,
         plain_step_peak_memory_gb=plain["peak_memory_gb"],
         step_peak_growth_gb=peak / 1e9 - plain["peak_memory_gb"])


def sharded_phase(device, smi, grid, workloads, horizon, rows, rows_c,
                  walls):
    """The multi-device paths that one card can run: the lane splitter
    over a device list naming the card twice (every shard launches the
    round step), the refusals, and the DTensor train step on a one-rank
    (1, 1) layout of an nccl group."""
    t_phase = time.time()
    out = {"devices": SHARDED_DEVICES}
    n_fb = sum(p.system == "fb" for p in grid)
    n_flb = sum(p.system == "flb_nub" for p in grid)
    out["pad_lanes"] = {"fb": -n_fb % len(SHARDED_DEVICES),
                        "flb_nub": -n_flb % len(SHARDED_DEVICES)}
    # (a) the sweep, plain and coalesced, split over the list
    for key, opts, want, wall in (
            ("sweep", ScanOptions(), rows, walls["sweep"]),
            ("sweep_coalesced", ScanOptions(coalesce=COALESCE), rows_c,
             walls["sweep_coalesced"])):
        zero_counts()
        t0 = time.time()
        got = run_sweep_workloads(grid, workloads, horizon, mode="rounds",
                                  device=device, scan_options=opts,
                                  devices=SHARDED_DEVICES)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        counts = read_counts()
        if got != want:
            bad = [(w, i) for w in range(len(want))
                   for i, (a, b) in enumerate(zip(want[w], got[w]))
                   if a != b]
            raise AssertionError(f"sharded {key}: rows differ from "
                                 f"devices=None's at {bad[:5]}")
        shards = len(SHARDED_DEVICES) * len(workloads) * 2
        if counts["round_step"] != shards or counts["round_step_chunk"]:
            raise AssertionError(f"sharded {key}: {counts}, expected "
                                 f"{shards} round_step launches")
        out[key] = {"wall_s": wall_s, "devices_none_wall_s": wall,
                    "round_step_launches": counts["round_step"],
                    "rows_equal_devices_none": True}
    # (b) the headline queries through the splitter
    t0 = time.time()
    hl = headline_queries(devices=SHARDED_DEVICES, device=device)
    torch.cuda.synchronize()
    answers = (hl["private"]["min_fb_capacity"], hl["private"]["dcs_size"],
               hl["public"]["flb_peak"], hl["public"]["ec2_peak"])
    if answers != (135, 256, 660, 1075):
        raise AssertionError(f"sharded headline: {answers}")
    out["headline"] = {"answers": answers, "wall_s": time.time() - t0,
                       "devices_none_wall_s": walls["headline"]}
    # (c) the refusals: an int beyond the visible cards, a fault pack
    visible = torch.cuda.device_count()
    try:
        run_sweep_workloads(grid[:1], workloads[:1], 2 * DAY,
                            mode="rounds", device=device,
                            devices=max(2, visible + 1))
        raise AssertionError(f"devices={max(2, visible + 1)} did not "
                             f"raise")
    except ValueError as e:
        if f"only {visible} CUDA device" not in str(e):
            raise
        out["devices_beyond_visible"] = str(e)
    jobs, ws = cut(workloads[:1], 2 * DAY)[0]
    sched = exponential_schedule(seed=7, n_nodes=16, mtbf=6 * 3600.0,
                                 mttr=1800.0, duration=2 * DAY)
    spec = roundslib.RoundsSpec(duration=2 * DAY, max_rounds=4096,
                                window=roundslib.FB_ROUNDS_WINDOW)
    pk = roundslib.pack_event_workloads(
        [(jobs, ws)], 2 * DAY, spec.window, "fb", [3600.0], [135.0],
        faults=[sched], device=device)
    fb = FBGrid(capacity=torch.tensor([135.0], device=device),
                lease=torch.tensor([3600.0], device=device))
    try:
        roundslib.rounds_grids(fb, None, pk, None, fb_spec=spec,
                               devices=SHARDED_DEVICES)
        raise AssertionError("a fault pack with devices did not raise")
    except NotImplementedError as e:
        out["fault_pack"] = str(e)
    # (d) the DTensor train step on a one-rank nccl group
    with one_rank_layout() as layout:
        train = {}
        for arch in SHARDED_TRAIN:
            cfg = reduced_config(get_config(arch))
            jc = TrainJobConfig(arch=arch, steps=SHARDED_STEPS, batch=4,
                                seq_len=64, lr=1e-3, accum_steps=2)
            t0 = time.time()
            plain = TrainJob(cfg, jc, device)
            plain.run()
            plain_s = time.time() - t0
            t0 = time.time()
            job = TrainJob(cfg, jc, layout)
            job.run()
            mesh_s = time.time() - t0
            if type(job.model.embed).__name__ != "DTensor":
                raise AssertionError(f"{arch}: the layout's weights are "
                                     f"not DTensors")
            if job.history != plain.history:
                raise AssertionError(f"{arch}: losses on the (1, 1) layout "
                                     f"{job.history} != {plain.history}")
            train[arch] = {"losses": job.history, "equal_bit_for_bit": True,
                           "wall_s": mesh_s, "plain_wall_s": plain_s}
        out["train_1x1"] = train
    # (e) two ranks sharing the card: decided before running
    missing = sorted(EF_ALLREDUCE_OPS - GLOO_CUDA_OPS)
    out["two_rank"] = "cpu only" if missing else "run"
    out["two_rank_refused_by_gloo_on_cuda"] = missing
    out["nvidia_smi"] = smi
    out["phase_wall_s"] = time.time() - t_phase
    emit("sharded", **out)
    return out


def mean_of(cases, key):
    return sum(c[key] for c in cases) / len(cases)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    big, small = traces.TWO_WEEKS, 2 * DAY
    t_all = time.time()

    # --- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # --- build: one nvcc per source, all started together
    t0 = time.time()
    libraries = (rsk.LIBRARY, fak.LIBRARY, fdk.LIBRARY, ssk.LIBRARY,
                 jsk.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(verbose=True),
                              libraries))
    emit("build", seconds=time.time() - t0,
         libraries=[b.name for b in built],
         flags={lib.name: " ".join(lib.flags) for lib in libraries})

    # --- kernel vs plain, chunk by chunk, on the sweep's own packs
    wc = traces.worldcup98(seed=0, peak_vms=128)
    workloads = [(traces.nasa_ipsc(seed=0), wc), (traces.sdsc_blue(seed=0),
                                                  wc)]
    trace_names = ("nasa_ipsc", "sdsc_blue")
    runs = []
    for batch in (None, COALESCE):
        for wl, horizon, dtype in ((workloads, big, torch.float32),
                                   (cut(workloads, small), small,
                                    torch.float64)):
            for policy, w, grid, pk, spec in sweep_lanes(
                    wl, horizon, dtype, device, coalesce=batch):
                r = kernel_vs_plain(policy, trace_names[w], grid, pk, spec,
                                    horizon)
                runs.append(r)
                emit("kernel_vs_plain", **r)
    idle = [r for r in runs if r["batch"] > 1 and not r["coalesced"] > 0]
    if idle:
        raise AssertionError(f"the coalescer never engaged: {idle}")

    # --- the main path: the paper-grid sweep through the kernel
    grid = paper_grid(128)
    zero_counts()
    t0 = time.time()
    rows = run_sweep_workloads(grid, workloads, big, mode="rounds",
                               device=device)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    counts = read_counts()
    launches, steps = counts["round_step"], rsk.outer_steps()
    # one launch per (trace, policy); kernel_vs_plain stepped the same
    # packs the same way, chunk by chunk.
    f32 = [r for r in runs if r["dtype"] == "float32" and r["batch"] == 1]
    if launches != len(f32) or any(v for k, v in counts.items()
                                   if k != "round_step"):
        raise AssertionError(f"the sweep's launches: {counts}, expected "
                             f"{len(f32)} runs")
    if steps != sum(r["chunks"] for r in f32):
        raise AssertionError(f"the sweep ran {steps} outer steps, the "
                             f"chunk-by-chunk check "
                             f"{sum(r['chunks'] for r in f32)}")
    split = wall_split(lambda: run_sweep_workloads(
        grid, workloads, big, mode="rounds", device=device))
    t0 = time.time()
    plain = run_sweep_workloads(grid, workloads, big, mode="rounds",
                                device=device,
                                scan_options=ScanOptions(kernel="torch"))
    plain_s = time.time() - t0
    for w in range(len(workloads)):
        rows_equal(rows[w], plain[w], INTEGRAL_RTOL[torch.float32],
                   f"sweep workload {w}")
    t0 = time.time()
    nasa = workloads[0][0]
    event = [None if p.system not in ("fb", "flb_nub") else
             run_sim(_build(p), clone_jobs(nasa), wc, big,
                     name=p.name()).row() for p in grid]
    event_s = time.time() - t0
    violations = check_fidelity(
        [r if r["system_kind"] in ("fb", "flb_nub") else None
         for r in rows[0]], event)
    if violations:
        raise AssertionError(f"rounds contract violated: {violations}")
    max_rounds = max(r.get("rounds", 0) for rs in rows for r in rs)
    emit("sweep", points=len(grid), workloads=len(workloads),
         horizon_days=big / DAY, kernel_launches=launches,
         outer_steps=steps, kernel_device_ms=sum(r["run_ms"] for r in f32),
         wall_s=sweep_s, wall_split=split, rows_equal_plain=True,
         plain_wall_s=plain_s, event_wall_s=event_s,
         max_rounds=max_rounds,
         contract=CONTRACTS["rounds"].__dict__, rows_nasa=rows[0])

    # --- the coalesced sweep through the kernel
    coal_opts = ScanOptions(coalesce=COALESCE)
    zero_counts()
    t0 = time.time()
    rows_c = run_sweep_workloads(grid, workloads, big, mode="rounds",
                                 device=device, scan_options=coal_opts)
    torch.cuda.synchronize()
    coal_s = time.time() - t0
    counts = read_counts()
    launches_c, steps_c = counts["round_step"], rsk.outer_steps()
    f32_c = [r for r in runs if r["dtype"] == "float32" and r["batch"] > 1]
    if launches_c != len(f32_c) or steps_c != sum(
            r["chunks"] for r in f32_c) or any(
            v for k, v in counts.items() if k != "round_step"):
        raise AssertionError(f"the coalesced sweep's launches: {counts}, "
                             f"{steps_c} outer steps; the chunk-by-chunk "
                             f"check {sum(r['chunks'] for r in f32_c)}")
    for w in range(len(workloads)):
        for i, (a, b) in enumerate(zip(rows[w], rows_c[w])):
            if a["system_kind"] in ("fb", "flb_nub") and \
                    a["completed_jobs"] != b["completed_jobs"]:
                raise AssertionError(
                    f"coalesced sweep workload {w} row {i}: completed "
                    f"{b['completed_jobs']} vs {a['completed_jobs']}")
    violations = check_fidelity(
        [r if r["system_kind"] in ("fb", "flb_nub") else None
         for r in rows_c[0]], event)
    if violations:
        raise AssertionError(f"coalesced rounds contract violated: "
                             f"{violations}")
    split_c = wall_split(lambda: run_sweep_workloads(
        grid, workloads, big, mode="rounds", device=device,
        scan_options=coal_opts))
    # Both walls again, in the other order (coalesced first).
    again = {}
    for name, opts in (("coalesced", coal_opts),
                       ("uncoalesced", ScanOptions())):
        t0 = time.time()
        run_sweep_workloads(grid, workloads, big, mode="rounds",
                            device=device, scan_options=opts)
        torch.cuda.synchronize()
        again[name] = time.time() - t0
    emit("sweep_coalesced", batch=COALESCE, kernel_launches=launches_c,
         outer_steps=steps_c,
         kernel_device_ms=sum(r["run_ms"] for r in f32_c),
         max_rounds=max(r.get("rounds", 0) for rs in rows_c for r in rs),
         coalesced=sum(r.get("coalesced", 0) for rs in rows_c for r in rs),
         wall_s=coal_s, wall_again_s=again["coalesced"], wall_split=split_c,
         uncoalesced={"kernel_launches": launches, "outer_steps": steps,
                      "max_rounds": max_rounds, "wall_s": sweep_s,
                      "wall_again_s": again["uncoalesced"],
                      "kernel_device_ms": sum(r["run_ms"] for r in f32),
                      "wall_split": split},
         rows_nasa=rows_c[0])

    # --- headline queries, coalescing off and on
    ref = json.loads((ROOT / "results" / "BENCH_capacity.json"
                      ).read_text())["headline"]
    walls = {}
    for phase, opts in (("headline", ScanOptions()),
                        ("headline_coalesced", coal_opts)):
        zero_counts()
        t0 = time.time()
        hl = headline_queries(scan_options=opts, device=device)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        hl_counts = read_counts()
        hl_launches, hl_steps = hl_counts["round_step"], rsk.outer_steps()
        for part, key in (("private", "min_fb_capacity"),
                          ("private", "dcs_size"), ("public", "flb_peak"),
                          ("public", "ec2_peak")):
            if hl[part][key] != ref[part][key]:
                raise AssertionError(f"{phase} {key}: {hl[part][key]} != "
                                     f"{ref[part][key]}")
        gate = HEADLINE_CONTRACT.check(hl["private"]["config_reduction"],
                                       hl["public"]["peak_reduction"])
        if gate or not hl["gate"]["ok"]:
            raise AssertionError(f"{phase} HEADLINE_CONTRACT: {gate}")
        if hl_launches == 0 or hl_counts["round_step_chunk"]:
            raise AssertionError(f"{phase} launches: {hl_counts}")
        walls[phase] = wall_s
        hl_split = wall_split(lambda: headline_queries(scan_options=opts,
                                                       device=device))
        emit(phase, wall_s=wall_s, headline_wall_s=walls["headline"],
             round_step_launches=hl_launches, outer_steps=hl_steps,
             wall_split=hl_split, **hl)

    # --- more than one device, as far as one card shows it
    walls["sweep"], walls["sweep_coalesced"] = sweep_s, coal_s
    sharded_phase(device, smi, grid, workloads, big, rows, rows_c, walls)

    # --- the §6.6.4 FLB-NUB study: one jaxsim launch per study
    jaxsim = jaxsim_phase(device, smi)

    # --- the serving slice at gemma2-2b's full width
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    dtypes = (torch.float32, torch.bfloat16)
    attn = [attn_case(cfg, s, w, dt, device, gen) for s in ATTN_SEQS
            for w in ATTN_WINDOWS for dt in dtypes]
    attn += [attn_case(cfg, ATTN_SEQS[1], ATTN_WINDOWS[0], dt, device, gen,
                       q_scale=CAP_Q_SCALE) for dt in dtypes]
    # the generate phase's prefill shape: bfloat16, batch 8, S 4600
    attn += [attn_case(cfg, GEN_PROMPT, w, torch.bfloat16, device, gen,
                       batch=GEN_BATCH) for w in ATTN_WINDOWS]
    # granite-moe-3b's attention: hd 64, G 3, no window, no softcap; the
    # batch-8 case's plain version holds 16 GB of float32 scores
    moe_cfg = get_config(MOE_ARCH)
    attn += [attn_case(moe_cfg, GEN_PROMPT, None, dt, device, gen)
             for dt in dtypes]
    torch.cuda.empty_cache()
    attn += [attn_case(moe_cfg, GEN_PROMPT, None, torch.bfloat16, device,
                       gen, batch=GEN_BATCH)]
    check_cases("attn_kernel_vs_plain", attn)
    dec = [decode_case(cfg, p, w, dt, device, gen) for p in DECODE_POSITIONS
           for w in ATTN_WINDOWS for dt in dtypes]
    dec += [decode_case(cfg, DECODE_CAP_POS, ATTN_WINDOWS[0], dt, device,
                        gen, q_scale=CAP_Q_SCALE) for dt in dtypes]
    dec += [decode_case(moe_cfg, p, None, dt, device, gen)
            for p in DECODE_POSITIONS for dt in dtypes]
    check_cases("decode_kernel_vs_plain", dec)
    torch.cuda.empty_cache()
    serve = serve_phase(cfg, device, "serve", SERVE_PROMPTS, SERVE_MAX_LEN,
                        "flash_attention")
    generate = generate_phase(
        cfg, device, "generate", GEN_BATCH, GEN_PROMPT, DECODE_CACHE,
        {"flash_decode": cfg.n_layers * GEN_STEPS,
         "flash_attention": cfg.n_layers})

    # --- the MoE slice at granite-moe-3b's full width and depth
    serve_moe = serve_phase(moe_cfg, device, "serve_moe", SERVE_PROMPTS,
                            SERVE_MAX_LEN, "flash_attention")
    generate_moe = generate_phase(
        moe_cfg, device, "generate_moe", GEN_BATCH, GEN_PROMPT,
        DECODE_CACHE, {"flash_decode": moe_cfg.n_layers * GEN_STEPS,
                       "flash_attention": moe_cfg.n_layers})

    # --- the Mamba2 slice at mamba2-130m's full width
    ssm_cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    ssd = [ssd_case(ssm_cfg, batch, seq, dt, device, gen, with_s0=s0,
                    strong_decay=strong, sequential=seq <= SSD_SEQ_MAX)
           for batch, seq, s0, strong in SSD_CASES for dt in dtypes]
    check_cases("ssd_kernel_vs_plain", ssd)
    torch.cuda.empty_cache()
    serve_ssm = serve_phase(ssm_cfg, device, "serve_mamba", SSM_PROMPTS,
                            SERVE_MAX_LEN, "ssd_scan")
    generate_ssm = generate_phase(
        ssm_cfg, device, "generate_mamba", GEN_SSM_BATCH, GEN_SSM_PROMPT,
        GEN_SSM_PROMPT + GEN_STEPS, {"ssd_scan": ssm_cfg.n_layers})

    # --- the last two families: whisper-base (encoder-decoder),
    # llama-3.2-vision (cross-attention layers) and jamba (the hybrid)
    wh_cfg = get_config(WHISPER_ARCH)
    vis_cfg = dataclasses.replace(get_config(VISION_ARCH),
                                  n_layers=VISION_LAYERS)
    hy_cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=8,
                                 d_ff=HYBRID_D_FF)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    # attention at hd 128, G 8 (llama-vision's and jamba's layers, no
    # window, no softcap) and at hd 64, G 1 (whisper's decoder)
    fam = [attn_case(c, s, None, torch.bfloat16, device, gen,
                     batch=GEN_BATCH)
           for c, s in ((hy_cfg, HYBRID_PROMPT), (vis_cfg, VISION_PROMPT),
                        (wh_cfg, GEN_WHISPER_PROMPT))]
    torch.cuda.empty_cache()
    fam += [attn_case(c, s, None, torch.float32, device, gen)
            for c, s in ((hy_cfg, HYBRID_PROMPT),
                         (wh_cfg, GEN_WHISPER_PROMPT))]
    check_cases("attn_kernel_vs_plain", fam)
    attn += fam
    # decode at the generate phases' first and last positions
    fam = [decode_case(c, p, None, dt, device, gen, cache=prompt + GEN_STEPS)
           for c, prompt in ((wh_cfg, GEN_WHISPER_PROMPT),
                             (vis_cfg, VISION_PROMPT),
                             (hy_cfg, HYBRID_PROMPT))
           for p in (prompt, prompt + GEN_STEPS - 1) for dt in dtypes]
    check_cases("decode_kernel_vs_plain", fam)
    dec += fam
    # the SSD scan at jamba's widths through ops.ssd (one B / C group,
    # copied to each of the 128 heads)
    fam = [ssd_case(hy_cfg, b, HYBRID_PROMPT, dt, device, gen, with_s0=s0,
                    via_ops=True)
           for b, dt, s0 in ((GEN_BATCH, torch.bfloat16, False),
                             (1, torch.float32, True))]
    check_cases("ssd_kernel_vs_plain", fam)
    ssd += fam
    torch.cuda.empty_cache()
    serve_wh = serve_phase(wh_cfg, device, "serve_whisper", WHISPER_PROMPTS,
                           WHISPER_CONTEXT, "flash_attention")
    generate_wh = generate_phase(
        wh_cfg, device, "generate_whisper", GEN_BATCH, GEN_WHISPER_PROMPT,
        WHISPER_CONTEXT, {"flash_attention": wh_cfg.n_layers,
                          "flash_decode": wh_cfg.n_layers * GEN_STEPS})
    n_self = sum(sp.mixer == ATTN for sp in vis_cfg.layer_pattern()) \
        * vis_cfg.n_periods
    generate_vis = generate_phase(
        vis_cfg, device, "generate_vision", GEN_BATCH, VISION_PROMPT,
        VISION_PROMPT + GEN_STEPS,
        {"flash_attention": n_self, "flash_decode": n_self * GEN_STEPS},
        reduced="n_layers 100 -> 10 (2 of 20 periods: 8 self-attention, "
                "2 cross-attention layers)")
    generate_hy = generate_phase(
        hy_cfg, device, "generate_hybrid", GEN_BATCH, HYBRID_PROMPT,
        HYBRID_PROMPT + GEN_STEPS,
        {"flash_attention": 1, "ssd_scan": 7, "flash_decode": GEN_STEPS},
        reduced="n_layers 72 -> 8 (one period: 1 attention, 7 Mamba2 "
                "layers), d_ff 24576 -> 3072")

    # --- the chaos tier (fault lanes on the plain step) and the live tier;
    # last, so that its profile of one plain step comes after the model
    # phases' profiler checks
    chaos_phase(device, smi)
    # --- the scan engine (no kernel) and a generated scenario batch at
    # width 1024 (one round_step launch per policy)
    scan_phase(device, smi)
    scen = scenarios_phase(device, smi)
    zero_counts()
    live_phase(device, smi)
    if any(read_counts().values()):
        raise AssertionError(f"the live tier launched: {read_counts()}")

    # --- training on the card: the plain path under autograd (no kernel
    # launch), gemma2-2b at full width and depth, each family's reduced
    # config against the CPU, resume after a worker failure, and a live
    # training job preempted and resumed on the LiveCloud
    torch.cuda.empty_cache()
    plain = train_full_phase(device, smi)
    sharded_train_full_phase(device, smi, plain)
    train_reduced_phase(device, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_resume_phase(device, smi, Path(tmp))
        live_train_phase(device, smi, Path(tmp))

    # --- the dry run: every arch x shape cell's cost and memory forecast
    # on meta, checked against the card where it fits
    torch.cuda.empty_cache()
    dryrun_phase(device, smi)

    # --- the kernel table line
    # round_step: times and bounds at the main path's shapes, the float32
    # two-week packs of both traces and policies, weighted by launches.
    def per_launch(key, cases=f32):
        return (sum(r[key] * r["chunks"] for r in cases)
                / sum(r["chunks"] for r in cases))

    # round_step: the engine's one-launch runs of the sweep (one per
    # trace and policy), each timed, bounded and held against the plain
    # host loop on its own pack; per launch, the mean over the runs.
    def per_run(key, cases=f32):
        return sum(r[key] for r in cases) / len(cases)

    line = {"kernels": [{
        "name": "round_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/round_step.cu",
        "replaces": "src/repro/kernels/round_step.py:165",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": per_run("run_ms"),
        "plain_ms": per_run("plain_run_ms"),
        "bound_ms": per_run("run_bound_ms"),
        "bound_by": "bytes" if 2 * sum(r["run_bound_by"] == "bytes"
                                       for r in f32) >= len(f32)
        else "operations",
        "library_ms": None,
        # the outer steps of those runs (the per-chunk path's launches),
        # and the one-step entry's time per launch (launch-weighted)
        "outer_steps": steps,
        "ms_per_outer_step": sum(r["run_ms"] for r in f32) / steps,
        "chunk_ms": per_launch("kernel_ms_per_launch"),
        "chunk_bound_ms": per_launch("bound_ms"),
        # the same for the coalesced sweep (batch 8)
        "coalesced_launches": launches_c,
        "coalesced_outer_steps": steps_c,
        "coalesced_ms": per_run("run_ms", f32_c),
        "coalesced_plain_ms": per_run("plain_run_ms", f32_c),
        "coalesced_bound_ms": per_run("run_bound_ms", f32_c),
        "coalesced_ms_per_outer_step": sum(r["run_ms"] for r in f32_c)
        / steps_c,
        "coalesced_chunk_ms": per_launch("kernel_ms_per_launch", f32_c),
        "coalesced_max_abs_err": max(r["max_abs_err"] for r in f32_c),
        # the generated scenario batch at width 1024: one run per policy
        # (615 FB and 410 FLB-NUB lanes), its device ms and bound
        "scenario_launches": scen["launches"],
        "scenario_outer_steps": scen["outer_steps"],
        "scenario_ms": [x["device_ms"] for x in scen["per_launch"]],
        "scenario_bound_ms": [x["bound_ms"] for x in scen["per_launch"]],
        "scenario_lanes": [x["lanes"] for x in scen["per_launch"]],
    }]}
    # One row per attention kernel and dtype, at its path's shape, the
    # mean of its local (window 4096) and global layers: flash_attention
    # float32 on serve (b 1, the ragged S 4600), bfloat16 on generate's
    # prefill (batch 8, S 4600); flash_decode bfloat16 on generate's
    # step (batch 8, pos 4616).
    short = {"float32": "f32", "bfloat16": "bf16"}
    # granite-moe-3b's rows (suffix _moe): flash_attention float32 on
    # serve_moe (b 1, S 4600), bfloat16 on generate_moe's prefill (batch
    # 8, S 4600), flash_decode bfloat16 on generate_moe's step (pos 4616).
    for name, cases, launches_on_path, match, suffix in (
            ("flash_attention", attn, serve["launches"]["flash_attention"],
             dict(arch=LM_ARCH, seq=4600, dtype="float32", q_scale=1.0,
                  batch=1), ""),
            ("flash_attention", attn,
             generate["launches"]["flash_attention"],
             dict(arch=LM_ARCH, seq=GEN_PROMPT, dtype="bfloat16",
                  q_scale=1.0, batch=GEN_BATCH), ""),
            ("flash_decode", dec, generate["launches"]["flash_decode"],
             dict(arch=LM_ARCH, pos=4616, dtype="bfloat16", q_scale=1.0),
             ""),
            ("flash_attention", attn,
             serve_moe["launches"]["flash_attention"],
             dict(arch=MOE_ARCH, seq=4600, dtype="float32", batch=1),
             "_moe"),
            ("flash_attention", attn,
             generate_moe["launches"]["flash_attention"],
             dict(arch=MOE_ARCH, seq=GEN_PROMPT, dtype="bfloat16",
                  batch=GEN_BATCH), "_moe"),
            ("flash_decode", dec, generate_moe["launches"]["flash_decode"],
             dict(arch=MOE_ARCH, pos=4616, dtype="bfloat16"), "_moe"),
            # the last two families: whisper's decoder (hd 64, G 1)
            # float32 on serve_whisper (b 1, its longest prompt, 416),
            # bfloat16 on generate_whisper (batch 8, S 416, decode over
            # the 448 context); llama-vision's and jamba's layers (hd 128,
            # G 8) on their generate phases (batch 8, S 1024 / 2048); a
            # decode row is the mean of the phase's first and last step
            ("flash_attention", attn,
             serve_wh["launches"]["flash_attention"],
             dict(arch=WHISPER_ARCH, seq=GEN_WHISPER_PROMPT,
                  dtype="float32", batch=1), "_whisper"),
            ("flash_attention", attn,
             generate_wh["launches"]["flash_attention"],
             dict(arch=WHISPER_ARCH, seq=GEN_WHISPER_PROMPT,
                  dtype="bfloat16", batch=GEN_BATCH), "_whisper"),
            ("flash_decode", dec, generate_wh["launches"]["flash_decode"],
             dict(arch=WHISPER_ARCH, dtype="bfloat16"), "_whisper"),
            ("flash_attention", attn,
             generate_vis["launches"]["flash_attention"],
             dict(arch=VISION_ARCH, seq=VISION_PROMPT, dtype="bfloat16",
                  batch=GEN_BATCH), "_vision"),
            ("flash_decode", dec, generate_vis["launches"]["flash_decode"],
             dict(arch=VISION_ARCH, dtype="bfloat16"), "_vision"),
            ("flash_attention", attn,
             generate_hy["launches"]["flash_attention"],
             dict(arch=HYBRID_ARCH, seq=HYBRID_PROMPT, dtype="bfloat16",
                  batch=GEN_BATCH), "_jamba"),
            ("flash_decode", dec, generate_hy["launches"]["flash_decode"],
             dict(arch=HYBRID_ARCH, dtype="bfloat16"), "_jamba")):
        sel = [c for c in cases if all(c[k] == v for k, v in match.items())]
        same_dtype = [c for c in cases if c["dtype"] == match["dtype"]]
        row = {
            "name": f"{name}_{short[match['dtype']]}{suffix}",
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"flash_attention":
                         "src/repro/kernels/flash_attention.py:122",
                         "flash_decode":
                         "src/repro/kernels/flash_decode.py:98"}[name],
            "launches": launches_on_path,
            "max_abs_err": max(c["max_abs_err"] for c in same_dtype),
            "ms": mean_of(sel, "ms"),
            "plain_ms": mean_of(sel, "plain_ms"),
            "bound_ms": mean_of(sel, "bound_ms"),
            "bound_by": sel[0]["bound_by"],
            "library_ms": mean_of(sel, "library_ms"),
            "dtype": match["dtype"],
        }
        if match["dtype"] == "float32" and name == "flash_attention":
            row["cuda_core_bound_ms"] = mean_of(sel, "cuda_core_bound_ms")
        if not sel:
            raise AssertionError(f"no timed case for the {row['name']} row")
        line["kernels"].append(row)
    # ssd_scan, one row per dtype on its path: bfloat16 on generate_mamba's
    # prefill (batch 8, L 4096), float32 on serve_mamba's admissions (its
    # longest, b 1, L 4096).
    for launches_on_path, match in (
            (generate_ssm["launches"]["ssd_scan"],
             dict(batch=GEN_SSM_BATCH, dtype="bfloat16")),
            (serve_ssm["launches"]["ssd_scan"],
             dict(batch=1, dtype="float32"))):
        sel = [c for c in ssd if c["batch"] == match["batch"] and
               c["seq"] == GEN_SSM_PROMPT and c["dtype"] == match["dtype"]
               and not c["with_s0"] and not c["strong_decay"]]
        row = {
            "name": f"ssd_scan_{short[match['dtype']]}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:79",
            "launches": launches_on_path,
            "max_abs_err": max(c["max_abs_err"] for c in ssd
                               if c["dtype"] == match["dtype"]
                               and c["arch"] == SSM_ARCH),
            "ms": mean_of(sel, "ms"),
            "plain_ms": mean_of(sel, "plain_ms"),
            "bound_ms": mean_of(sel, "bound_ms"),
            "bound_by": sel[0]["bound_by"],
            "library_ms": None,
            "dtype": match["dtype"],
            "kernel_launches_per_call": sel[0]["kernel_launches_per_call"],
            "chain_ms": mean_of(sel, "chain_ms"),
        }
        if match["dtype"] == "float32":
            row["cuda_core_bound_ms"] = mean_of(sel, "cuda_core_bound_ms")
        line["kernels"].append(row)
    # ssd_scan at jamba's widths (128 heads of P 128, one B / C group) on
    # generate_hybrid's prefill (batch 8, L 2048): the kernel alone, and
    # ops.ssd with its per-head copies of B / C beside it
    sel = [c for c in ssd if c["arch"] == HYBRID_ARCH
           and c["dtype"] == "bfloat16"]
    line["kernels"].append({
        "name": "ssd_scan_bf16_jamba",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:79",
        "launches": generate_hy["launches"]["ssd_scan"],
        "max_abs_err": sel[0]["max_abs_err"],
        "ms": sel[0]["ms"],
        "plain_ms": sel[0]["plain_ms"],
        "bound_ms": sel[0]["bound_ms"],
        "bound_by": sel[0]["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "kernel_launches_per_call": sel[0]["kernel_launches_per_call"],
        "chain_ms": sel[0]["chain_ms"],
        "ops_ms": sel[0]["ops_ms"],
        "ops_bound_ms": sel[0]["ops_bound_ms"],
        "bc_copy_bytes": sel[0]["bc_copy_bytes"],
    })
    # jaxsim: the §6.6.4 study's one launch (12 lanes), its device ms and
    # bound, the measured cost of a substep beside the two modelled
    # floors of the design (chain_bound_ms, table_bound_ms); the plain
    # version's ms is its host loop on the card (the study's wall through
    # impl="torch").
    line["kernels"].append({
        "name": "jaxsim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/jaxsim.cu",
        "replaces": "src/repro/core/jaxsim.py:152 (lax.scan; no "
                    "pallas_call)",
        "launches": jaxsim["launches"],
        "max_abs_err": jaxsim["max_abs_err_vs_plain"],
        "ms": jaxsim["ms"],
        "plain_ms": 1e3 * jaxsim["plain_s"],
        "bound_ms": jaxsim["bound_ms"],
        "bound_by": jaxsim["bound_by"],
        "library_ms": None,
        "substep_us": jaxsim["substep_us"],
        "fixed_ms": jaxsim["fixed_ms"],
        "chain_bound_ms": jaxsim["chain_bound_ms"],
        "table_bound_ms": jaxsim["table_bound_ms"],
        "factorial_launches": jaxsim["factorial"]["launches"],
        "factorial_ms": jaxsim["factorial"]["ms"],
        "factorial_plain_ms": 1e3 * jaxsim["factorial"]["plain_s"],
        "factorial_bound_ms": jaxsim["factorial"]["bound_ms"],
    })
    emit("chain", chain_ms=per_launch("chain_ms"),
         bound_ms=per_launch("bound_ms"),
         coalesced_chain_ms=per_launch("chain_ms", f32_c),
         coalesced_bound_ms=per_launch("bound_ms", f32_c),
         note="serial chain of block barriers per launch x measured "
              "barrier cost, beside the bytes/operations bound; "
              "coalesced: every round with a queue, an upper bound")
    emit("done", wall_s=time.time() - t_all)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
