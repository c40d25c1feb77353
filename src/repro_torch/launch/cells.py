"""(architecture × input shape) cells on one card or a layout of
several: the counterpart of ``repro.launch.cells``.

The reference stands in ``ShapeDtypeStruct``s for every input, jits the
cell's entry point (train step, prefill or serve step) with shardings
and lowers it; XLA's cost and memory analyses then read the compiled
program. The port builds the same cell eagerly: on the meta device
(shapes and dtypes, no storage) for the dry run, or on the card to
check the dry run against it.

* ``input_specs``: the data inputs of a cell as meta tensors, with the
  reference's shapes and dtypes.
* ``build_cell``: the cell's model, arguments and step on a one-card
  layout (``mesh.make_local_mesh``), or on a layout of several cards
  (``mesh.make_mesh`` / ``make_production_mesh``): weights, optimizer
  state, cache and batch are DTensors placed by the sharding specs
  (``Model.param_specs``, ``Optimizer.state_specs``,
  ``Model.cache_pspecs``, ``trainer.batch_pspecs``), the counterpart of
  the reference's ``in_shardings``. Under PyTorch's ``fake`` process
  group on the meta device one process stands for every rank.
* ``count_cell`` (the reference's ``lower_cell``): runs the cell once
  under ``CostCounter``, which counts every aten op's FLOPs and bytes
  and each kernel route's (``kernels/cost.py``), and follows every
  storage's life to forecast the peak memory of the step. On a layout
  of several cards it counts one rank's local program (a DTensor op is
  let through, so the counter sees the local ops it becomes, and the
  collectives DTensor issues, ``hlo_analysis.Collectives``): per-card
  FLOPs, bytes, peak memory and collective bytes.
* ``analytic_cost``: the reference's global FLOPs and bytes of a cell,
  counted at full depth on the plain path.

The counting convention is XLA's ``cost_analysis``: 2 FLOPs a
multiply-add, 1 per output element of an elementwise op (a dtype
conversion included), 1 per input element of a reduction;
transcendentals (exp, log, tanh, rsqrt, ...) are counted apart and not
in ``flops``. Products and elementwise work are kept apart in the
record. Bytes are the port's eager traffic: the operands read and the
results written by each aten op (views move nothing) and each kernel
route's own (``kernels/cost.py``).
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig, ShapeSpec, get_config
from repro_torch.kernels import cost as kcost
from repro_torch.launch.hlo_analysis import Collectives, LocalOnly
from repro_torch.launch.mesh import Layout, make_local_mesh
from repro_torch.models.common import placed_empty
from repro_torch.models.transformer import FRONTEND_FAMILIES, Model
from repro_torch.train.optimizer import get_optimizer, tree_map
from repro_torch.train.trainer import batch_pspecs, make_train_step

__all__ = ["Cell", "CostCounter", "input_specs", "build_cell", "count_cell",
           "analytic_cost", "LR", "COUNTED_MICROBATCHES"]

# The learning rate a train cell's step is given, and the seed of a
# cell's random weights and data off the meta device.
LR = 1e-4
SEED = 0
# A train cell counts this many of its micro-batches and adds the last
# one's cost for each of the rest: from the second on, every micro-batch
# does the same work on the same live memory (the gradient sum exists).
COUNTED_MICROBATCHES = 3


# --------------------------------------------------------------- the counter

def _name(func) -> str:
    return func._overloadpacket.__name__.rstrip("_")


# XLA counts these as transcendentals, not flops.
TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log1p", "tanh",
                  "sigmoid", "rsqrt", "sqrt", "sin", "cos", "tan", "erf",
                  "atan2", "reciprocal"}
# Composite ops: (flops, transcendentals) per output element, as XLA
# counts the ops it decomposes them into.
COMPOSITE = {
    "_softmax": (4, 1),                   # max, sub, [exp], sum, div
    "_log_softmax": (4, 2),               # max, sub, [exp], sum, [log], sub
    "_softmax_backward_data": (4, 0),     # mul, sum, sub, mul
    "_log_softmax_backward_data": (3, 1),
    "silu": (1, 1),                       # x · [logistic(x)]
    "silu_backward": (5, 1),
    "softplus": (3, 2),                   # max, sub, add, [exp], [log1p]
    "softplus_backward": (3, 1),
    "tanh_backward": (3, 0),
    "sigmoid_backward": (3, 0),
    "threshold_backward": (2, 0),
}
# Reductions: one flop per input element.
REDUCTION = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
             "argmin", "cumsum", "cumprod", "logsumexp", "norm",
             "linalg_vector_norm", "var", "std", "all", "any"}
# Data movement with no arithmetic (0 flops), even where tagged
# pointwise.
MOVEMENT = {"clone", "copy", "_to_copy", "cat", "stack", "index", "gather",
            "index_select", "embedding", "index_copy", "scatter", "masked_select", "repeat", "repeat_interleave",
            "constant_pad_nd", "zero", "fill", "zeros", "ones", "full",
            "zeros_like", "ones_like", "full_like", "arange", "topk",
            "sort", "tril", "triu", "flip", "roll",
            "normal", "uniform", "random", "randint", "bernoulli"}
# Scatter-adds: one flop per update element.
ACCUMULATE = {"index_add", "scatter_add", "embedding_dense_backward",
              "_index_put_impl", "index_put"}


def _updates(name: str, args) -> int:
    """The elements a scatter-add adds (0 for a plain index_put)."""
    if name == "embedding_dense_backward":
        return args[0].numel()
    if name in ("index_add", "scatter_add"):
        return args[3].numel()
    accumulate = len(args) > 3 and bool(args[3])
    return args[2].numel() if accumulate else 0


# Ops that move no bytes: views, allocation, aliases.
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "_unsafe_view", "detach",
              "alias", "set", "resize", "_local_scalar_dense", "item",
              "_to_copy_meta"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, transcendentals and bytes of every aten op run
    under it (while ``counting``) and of every kernel route
    (``kernels.cost.report``), and follows the life of every storage an
    op creates (a weak reference to the storage; a storage dies when its
    last tensor does) to keep the live and peak bytes."""

    def __init__(self):
        super().__init__()
        self.counting = False
        self.products = 0
        self.elementwise = 0
        self.kernel_flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: Counter = Counter()
        self.by_op: Counter = Counter()     # flops by aten op name
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self.collectives = Collectives()
        self._local = LocalOnly()

    # -------------------------------------------------------- live memory

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    # -------------------------------------------------------------- counts

    def totals(self) -> Dict[str, float]:
        return {"products": self.products, "elementwise": self.elementwise,
                "kernel_flops": self.kernel_flops,
                "transcendentals": self.transcendentals,
                "bytes": self.bytes, "ops": self.ops,
                **{f"launches:{k}": v for k, v in self.kernels.items()}}

    def add(self, delta: Dict[str, float], times: int) -> None:
        """Adds ``times`` × ``delta`` (a difference of ``totals()``)."""
        for key, v in delta.items():
            if key.startswith("launches:"):
                self.kernels[key[9:]] += times * v
            else:
                setattr(self, key, getattr(self, key) + times * v)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        if self.counting:
            self.kernels[name] += 1
            self.kernel_flops += flops
            self.bytes += nbytes

    def __enter__(self):
        kcost.sinks.append(self._kernel)
        self._local.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.sinks.remove(self._kernel)
        out = super().__exit__(*exc)
        self._local.__exit__(*exc)
        return out

    def _flops(self, func, name, args, kwargs, out,
               outs) -> Tuple[str, float, float]:
        """(kind, flops, transcendentals) of one op: kind is "products"
        or "elementwise"."""
        if func._overloadpacket in flop_registry:
            return "products", flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out), 0
        n_out = sum(t.numel() for t in outs)
        if name in COMPOSITE:
            f, tr = COMPOSITE[name]
            return "elementwise", f * n_out, tr * n_out
        if name in ("_to_copy", "copy"):
            src = args[1] if name == "copy" else args[0]
            return "elementwise", n_out if src.dtype != outs[0].dtype \
                else 0, 0                       # a conversion
        if name in TRANSCENDENTAL:
            return "elementwise", 0, n_out
        if name == "pow":
            square = isinstance(args[1], (int, float)) and args[1] == 2
            return "elementwise", n_out if square else 0, \
                0 if square else n_out          # x * x, or a power
        if name in REDUCTION:
            return "elementwise", args[0].numel() + (
                n_out if name == "mean" else 0), 0
        if name in ACCUMULATE:
            return "elementwise", _updates(name, args), 0
        if name not in MOVEMENT and torch.Tag.pointwise in func.tags:
            return "elementwise", n_out, 0
        return "elementwise", 0, 0

    def _bytes(self, func, name, args, kwargs, outs) -> int:
        if func.is_view or name in NO_TRAFFIC:
            return 0
        ins = _tensors((args, kwargs))
        if name == "copy":                      # dst written, src read
            return _nbytes(ins[0]) + _nbytes(ins[1])
        if name in ("index_copy", "index_put", "_index_put_impl"):
            # the rows written (and read back) and the indices
            return sum(_nbytes(t) for t in ins[1:]) + \
                sum(_nbytes(t) for t in ins[-1:])
        if name in ("zero", "fill", "normal", "uniform", "random"):
            return sum(_nbytes(t) for t in outs)
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            # Let DTensor run first: the counter sees the local ops and
            # collectives it becomes, with each rank's shapes.
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten.lift_fresh.default:
            # A tensor made from Python data (a scalar on the model path)
            # is neither followed nor counted: on the meta device no op
            # shows it.
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if self.counting:
            self.collectives.record(func, args, out)
            name = _name(func)
            self.ops += 1
            kind, f, tr = self._flops(func, name, args, kwargs, out, outs)
            setattr(self, kind, getattr(self, kind) + f)
            self.transcendentals += tr
            self.by_op[name] += f
            self.bytes += self._bytes(func, name, args, kwargs, outs)
        return out


# --------------------------------------------------------------------- cells

@dataclasses.dataclass
class Cell:
    """One (architecture, shape) cell on one card. ``build(accum)``
    makes the model, the arguments and the step (``step(*args)``); a
    train cell takes the micro-batch count to run (``accum``, its own by
    default). A skipped cell has ``skip`` and no ``build``."""

    arch: str
    shape: str
    kind: str
    build: Optional[Callable[..., Tuple[Model, Callable, tuple]]] = None
    skip: Optional[str] = None
    accum: int = 1


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for the *data* inputs of a cell."""
    gb, s = shape.global_batch, shape.seq_len

    def spec(*size, dtype=torch.int32):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind == "train":
        out = {"tokens": spec(gb, s), "labels": spec(gb, s)}
    elif shape.kind == "prefill":
        out = {"tokens": spec(gb, s)}
    else:   # decode: one new token against a seq_len cache
        out = {"tokens": spec(gb, 1)}
    if cfg.family in FRONTEND_FAMILIES and shape.kind != "decode":
        out["frontend"] = spec(gb, cfg.frontend_len, cfg.d_model,
                               dtype=compute_dtype)
    return out


def _inputs(cfg: ArchConfig, shape: ShapeSpec, device: torch.device,
            compute_dtype, gen: Optional[torch.Generator], model=None):
    """``input_specs`` on ``device``: random tokens and frontend from
    ``gen`` (written in place, no temporaries), storage only on meta.
    For a ``model`` on a mesh each input is a DTensor placed by
    ``trainer.batch_pspecs`` (rows over the batch axes where they
    divide), holding this rank's rows only."""
    out = {}
    for name, sp in input_specs(cfg, shape, compute_dtype).items():
        if model is not None and model.mesh is not None:
            ax = model.ax
            spec = ax.spec(batch_pspecs(cfg, ax).get(
                name, (ax.batch_axes,) + (None,) * (len(sp.shape) - 1)),
                sp.shape)
            t = placed_empty(sp.shape, sp.dtype, device, ax.mesh,
                             ax.placements(spec))
            if gen is not None:
                raise NotImplementedError(
                    "random inputs on a mesh: the cell runs on meta")
            out[name] = t
            continue
        t = torch.empty(sp.shape, dtype=sp.dtype, device=device)
        if gen is not None:
            if t.dtype == torch.int32:
                t.random_(0, cfg.vocab, generator=gen)
            else:
                t.normal_(generator=gen)
        out[name] = t
    return out


@torch.no_grad()
def _fill(model: Model, gen: Optional[torch.Generator]) -> None:
    """Random weights in place (no temporaries): norms 0, every other
    tensor normal with stddev 0.02; nothing on meta."""
    if gen is None:
        return
    for name, p in model.named_parameters():
        if "norm" in name:
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=gen)


def build_cell(arch: str, shape_name: str, layout: Optional[Layout] = None,
               compute_dtype=torch.bfloat16, *,
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None, impl: Optional[str] = None,
               cfg: Optional[ArchConfig] = None) -> Cell:
    """The cell on ``layout`` (default: the card). Train: float32
    weights, the config's optimizer and ``accum = gb // min(microbatch,
    gb)`` micro-batches through ``make_train_step``; prefill and decode:
    bfloat16 weights and a bfloat16 cache of ``seq_len``, decode at its
    last position. ``global_batch`` and ``seq_len`` cut the shape,
    ``cfg`` replaces the config (a reduced one), ``impl`` the model's
    default for prefill and decode (the kernels on the card and on
    meta); train runs ``impl="torch"``, the path the trainer
    differentiates. Weights and data are random from ``SEED`` off the
    meta device.

    A layout of several cards (one with a ``DeviceMesh``) places
    weights, optimizer state, cache and batch by their specs, and the
    train step pins the gradients to the weights' placements
    (``grad_pspecs``); such a cell runs on the meta device. The
    micro-batches are the config's, consecutive global rows placed by
    ``batch_pspecs`` (``trainer._micro_batches``): where one has fewer
    rows than there are batch ranks (jamba's and llama-vision's 8 on 16)
    it is whole on each rank, as in the reference. A layout with no
    devices (a description) raises."""
    cfg = cfg or get_config(arch)
    shape = cfg.shapes()[shape_name]
    if shape.skip:
        return Cell(arch, shape_name, shape.kind, skip=shape.skip)
    layout = layout or make_local_mesh()
    if layout.device is None:
        raise ValueError(
            f"layout {layout.shape} has no devices: it needs a process "
            f"group of {layout.size} ranks (the dry run's fake group)")
    if layout.size != 1 and layout.mesh is None:
        raise ValueError(f"layout {layout.shape} of {layout.size} cards "
                         f"has no DeviceMesh")
    sharded = layout.mesh is not None
    device = layout.device
    where = layout if sharded else device
    gb = global_batch or shape.global_batch
    shape = dataclasses.replace(shape, global_batch=gb,
                                seq_len=seq_len or shape.seq_len)
    s = shape.seq_len

    def generator():
        if device.type == "meta":
            return None
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        return gen

    if shape.kind == "train":
        mb = min(cfg.microbatch or gb, gb)
        accum = max(1, gb // mb)

        def build_train(accum_steps: int = accum):
            gen = generator()
            model = Model(cfg, where, impl="torch",
                          compute_dtype=compute_dtype,
                          param_dtype=torch.float32)
            _fill(model, gen)
            model.requires_grad_(True)
            opt = get_optimizer(cfg.optimizer)
            params = model.params()
            state = opt.init(params)
            if sharded:
                # Only the micro-batches counted.
                batch = _inputs(cfg, dataclasses.replace(
                    shape, global_batch=accum_steps * mb), device,
                    compute_dtype, gen, model)
            else:
                batch = _inputs(cfg, shape, device, compute_dtype, gen)
                if accum_steps != accum:
                    batch = {k: v[:accum_steps * mb]
                             for k, v in batch.items()}
            step = make_train_step(model, opt, accum_steps,
                                   grad_pspecs=model.param_specs()
                                   if sharded else None)
            return model, step, (params, state, batch, LR)

        return Cell(arch, shape_name, "train", build_train, accum=accum)

    def build_serve(accum_steps: int = 1):
        gen = generator()
        model = Model(cfg, where, impl=impl, compute_dtype=compute_dtype,
                      param_dtype=torch.bfloat16)
        _fill(model, gen)
        cache = model.init_cache(gb, s, dtype=torch.bfloat16)
        batch = _inputs(cfg, shape, device, compute_dtype, gen, model)
        if shape.kind == "prefill":
            return model, model.prefill, (batch, cache)

        def decode(tokens, cache):
            return model.decode(tokens, cache, s - 1)

        return model, decode, (batch["tokens"], cache)

    return Cell(arch, shape_name, shape.kind, build_serve)


def _gb(nbytes: float) -> float:
    return nbytes / 2 ** 30


def count_cell(cell: Cell) -> Dict:
    """Runs the cell once under a ``CostCounter`` (the reference's
    ``lower_cell`` and XLA's analyses in one): its arguments are made
    under the counter and the step is counted. Returns the FLOPs
    (products, elementwise, kernel routes), transcendentals, bytes, kernel
    route launches, the peak of live bytes from the first argument to the
    step's end (``peak_bytes``) and the reference's ``memory_analysis``
    split: arguments (live when the step starts), outputs (new storage
    live when it ends) and temporaries (the rest of the peak); and the
    shape and dtype of the step's result (the logits, or the loss).

    A train cell of more than ``COUNTED_MICROBATCHES`` micro-batches
    counts that many and adds the last one's cost for each of the rest
    (its peak is already reached: the second micro-batch on run alike)."""
    if cell.skip:
        raise ValueError(f"cell {cell.arch}/{cell.shape} is skipped: "
                         f"{cell.skip}")
    c = CostCounter()
    runs = min(cell.accum, COUNTED_MICROBATCHES)
    snaps = []
    with c:
        model, step, args = cell.build(runs)
        if runs < cell.accum:
            loss = model.loss

            def snapshot_loss(batch):
                snaps.append(c.totals())
                return loss(batch)

            model.loss = snapshot_loss
        arguments = c.live
        c.counting = True
        out = step(*args)
        c.counting = False
        outputs = max(0, c.live - arguments)
        if runs < cell.accum:
            last = {k: snaps[-1].get(k, 0) - snaps[-2].get(k, 0)
                    for k in snaps[-1]}
            c.add(last, cell.accum - runs)
        t = out[2]["loss"] if cell.kind == "train" else out[0]
        result = {"shape": list(t.shape), "dtype": str(t.dtype)[6:]}
        del out, t, args, step, model
    flops = c.products + c.elementwise + c.kernel_flops
    return {"flops": flops, "products": c.products,
            "collectives": c.collectives.result(),
            "elementwise": c.elementwise, "kernel_flops": c.kernel_flops,
            "transcendentals": c.transcendentals, "bytes": c.bytes,
            "ops": c.ops, "kernel_launches": dict(c.kernels),
            "peak_bytes": c.peak, "argument_bytes": arguments,
            "output_bytes": outputs,
            "memory_analysis": {
                "argument_size_gb": _gb(arguments),
                "output_size_gb": _gb(outputs),
                "temp_size_gb": _gb(max(0, c.peak - arguments - outputs))},
            "result": result}


# ------------------------------------------------------- analytic cost path

def analytic_cost(arch: str, shape_name: str, compute_dtype=torch.bfloat16,
                  *, cfg: Optional[ArchConfig] = None,
                  global_batch: Optional[int] = None,
                  seq_len: Optional[int] = None) -> Dict[str, float]:
    """Global FLOPs / bytes of one cell, with the reference's semantics:
    the plain path (``impl="torch"``, the reference's ``force_dense``:
    dense global attention, banded local attention past 8192 tokens) on
    one device, at full depth (nothing compiles and no loop hides a
    body, so the reference's extrapolation in depth is not needed);
    train counts one micro-batch's loss and gradients, times the
    accumulation count, plus one optimizer update. Empty for a skipped
    cell. ``cfg``, ``global_batch`` and ``seq_len`` as ``build_cell``
    takes them."""
    cfg = cfg or get_config(arch)
    shape = cfg.shapes()[shape_name]
    if shape.skip:
        return {}
    gb = global_batch or shape.global_batch
    s = seq_len or shape.seq_len
    shape = dataclasses.replace(shape, seq_len=s)
    meta = torch.device("meta")
    c = CostCounter()
    with c:
        if shape.kind == "train":
            mb = min(cfg.microbatch or gb, gb)
            accum = max(1, gb // mb)
            model = Model(cfg, meta, impl="torch",
                          compute_dtype=compute_dtype)
            model.requires_grad_(True)
            batch = input_specs(cfg, dataclasses.replace(
                shape, global_batch=mb), compute_dtype)
            c.counting = True
            model.loss(batch).backward()
            c.counting = False
            grad_step = c.totals()
            c.add(grad_step, accum - 1)
            params = model.params()
            grads = tree_map(lambda p: p.grad, params)
            opt = get_optimizer(cfg.optimizer)
            state = opt.init(params)
            c.counting = True
            opt.update(grads, state, params, LR)
            c.counting = False
        else:
            model = Model(cfg, meta, impl="torch",
                          compute_dtype=compute_dtype,
                          param_dtype=torch.bfloat16)
            cache = model.init_cache(gb, s, dtype=torch.bfloat16)
            batch = input_specs(cfg, dataclasses.replace(
                shape, global_batch=gb), compute_dtype)
            c.counting = True
            if shape.kind == "prefill":
                model.prefill(batch, cache)
            else:
                model.decode(batch["tokens"], cache, s - 1)
            c.counting = False
    return {"flops": c.products + c.elementwise, "bytes": c.bytes,
            "products": c.products, "elementwise": c.elementwise,
            "transcendentals": c.transcendentals}
