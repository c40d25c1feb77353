"""Split the JAX package's analytic FLOP count of one cell by HLO opcode,
beside the port's count of the same cell by aten op.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_cost_parts.py \
        gemma2_2b decode_32k [--periods 1]

The reference's ``repro.launch.cells.analytic_cost`` compiles each cell
at 1 and 2 periods of layers on the CPU and reads XLA's
``cost_analysis()["flops"]``, then extrapolates in depth. Without
``--periods`` this script runs it as it stands, records the HLO of every
program it compiles, splits each by opcode and extrapolates the parts as
the reference extrapolates the total: one JSON line with the
reference's count, its ``dot`` and ``convert`` FLOPs, and the port's
``cells.analytic_cost`` beside them. With ``--periods`` it compiles the
same function at that depth (the reference's ``cell_cost``: unrolled
layers, ``force_dense``, microbatch rows for train) and lists the parts
of that one program, then the port's ``CostCounter`` over the same cell
on the meta device at the same depth (``impl="torch"``), its FLOPs by
aten op.

The split sums XLA's HloCostAnalysis convention over the optimized HLO
instruction by instruction: 2 FLOPs a multiply-add for ``dot``, 1 per
input element for ``reduce`` and ``reduce-window`` (times the window),
1 per output element for every other elementwise opcode;
transcendentals, data movement and fusion wrappers 0. Opcodes on
tensors of at least 2^30 elements are listed apart. With ``--periods``
the parsed total is printed beside ``cost_analysis()`` as its check.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import re

import jax
import jax.numpy as jnp

from repro.configs.base import get_config
from repro.launch.cells import input_specs
from repro.launch.mesh import make_local_mesh
from repro.models.attention import force_dense
from repro.models.transformer import Model

SDS = jax.ShapeDtypeStruct
ZERO = {"parameter", "constant", "bitcast", "broadcast", "reshape",
        "transpose", "slice", "dynamic-slice", "dynamic-update-slice",
        "copy", "tuple", "get-tuple-element", "iota", "concatenate", "pad",
        "fusion", "call", "gather", "custom-call", "reverse", "while",
        "conditional", "after-all", "partition-id", "replica-id", "sort",
        "rng-bit-generator", "rng-get-and-update-state", "bitcast-convert"}
TRANSCENDENTAL = {"exponential", "log", "tanh", "rsqrt", "sqrt", "logistic",
                  "exponential-minus-one", "log-plus-one", "sine", "cosine",
                  "power", "erf", "tan", "atan2", "cbrt"}
INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+) = \(?([a-z0-9]+)\[([0-9,]*)\]"
                   r"[^ ]* ([a-z\-]+)\((.*)")
SHAPE = re.compile(r"%([\w.\-]+) = ([a-z0-9]+)\[([0-9,]*)\]")
BIG = 2 ** 30


def _dims(s: str):
    return [int(x) for x in s.split(",") if x]


def hlo_parts(text: str) -> collections.Counter:
    shapes = {m.group(1): _dims(m.group(3)) for m in SHAPE.finditer(text)}
    parts = collections.Counter()
    for line in text.splitlines():
        m = INSTR.match(line)
        if not m:
            continue
        _, _, dims, op, rest = m.groups()
        n = math.prod(_dims(dims))
        if n <= 1 or op in ZERO or op in TRANSCENDENTAL:
            continue
        first = re.match(r"%([\w.\-]+)", rest)
        operand = shapes.get(first.group(1), []) if first else []
        if op == "dot":
            cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", rest)
            k = math.prod(operand[int(i)] for i in _dims(cd.group(1)))
            parts["dot"] += 2 * n * k
            continue
        if op == "reduce":
            parts["reduce"] += math.prod(operand)
            continue
        if op == "reduce-window":
            w = re.search(r"window=\{size=([0-9x]+)", rest)
            size = math.prod(int(x) for x in w.group(1).split("x"))
            parts["reduce-window"] += n * size
            continue
        parts[op + (" (>= 2^30 elements)" if n >= BIG else "")] += n
    return parts


def reference(arch: str, shape_name: str, periods: int):
    cfg = get_config(arch)
    shape = cfg.shapes()[shape_name]
    small = dataclasses.replace(
        cfg, n_layers=periods * len(cfg.layer_pattern()),
        encoder_layers=min(cfg.encoder_layers, periods))
    mesh = make_local_mesh()
    gb = shape.global_batch
    if shape.kind == "train":
        model = Model(small, mesh, compute_dtype=jnp.bfloat16, unroll=True)
        mb = min(cfg.microbatch or gb, gb)
        params = jax.eval_shape(lambda: model.init(0))
        batch = input_specs(small, dataclasses.replace(shape, global_batch=mb),
                            jnp.bfloat16)
        fn = lambda p, b: jax.value_and_grad(model.loss)(p, b)  # noqa: E731
        args = (params, batch)
    else:
        model = Model(small, mesh, compute_dtype=jnp.bfloat16,
                      param_dtype=jnp.bfloat16, unroll=True)
        params = jax.eval_shape(lambda: model.init(0))
        cache = jax.eval_shape(lambda: model.init_cache(
            gb, shape.seq_len, dtype=jnp.bfloat16))
        if shape.kind == "prefill":
            fn = model.prefill
            args = (params, input_specs(small, shape, jnp.bfloat16), cache)
        else:
            fn = model.decode
            args = (params, SDS((gb, 1), jnp.int32), cache,
                    SDS((), jnp.int32))
    with force_dense():
        compiled = jax.jit(fn).lower(*args).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"]), hlo_parts(compiled.as_text())


def port(arch: str, shape_name: str, periods: int):
    import torch
    from repro_torch.configs.base import get_config as port_config
    from repro_torch.launch.cells import CostCounter
    from repro_torch.launch.cells import input_specs as port_specs
    from repro_torch.models.transformer import Model as PortModel
    cfg = port_config(arch)
    shape = cfg.shapes()[shape_name]
    small = dataclasses.replace(
        cfg, n_layers=periods * len(cfg.layer_pattern()),
        encoder_layers=min(cfg.encoder_layers, periods))
    gb = shape.global_batch
    c = CostCounter()
    with c:
        if shape.kind == "train":
            model = PortModel(small, "meta", impl="torch")
            model.requires_grad_(True)
            mb = min(cfg.microbatch or gb, gb)
            batch = port_specs(small, dataclasses.replace(
                shape, global_batch=mb))
            c.counting = True
            model.loss(batch).backward()
        else:
            model = PortModel(small, "meta", impl="torch",
                              param_dtype=torch.bfloat16)
            cache = model.init_cache(gb, shape.seq_len)
            batch = port_specs(small, shape)
            c.counting = True
            if shape.kind == "prefill":
                model.prefill(batch, cache)
            else:
                model.decode(batch["tokens"], cache, shape.seq_len - 1)
        c.counting = False
    return c


def analytic_parts(arch: str, shape_name: str):
    """``repro.launch.cells.analytic_cost(arch, shape_name)`` as it
    stands, and ``hlo_parts`` of each program it compiles (depth 1,
    depth 2 and, for train, the optimizer's update), recorded through
    ``jax.jit`` while it runs."""
    from repro.launch.cells import analytic_cost
    texts = []
    jit = jax.jit

    class Recorded:
        def __init__(self, fn):
            self.jitted = jit(fn)

        def lower(self, *args):
            lowered = self.jitted.lower(*args)

            class Compiles:
                def compile(self):
                    compiled = lowered.compile()
                    texts.append(compiled.as_text())
                    return compiled

            return Compiles()

    jax.jit = Recorded
    try:
        cost = analytic_cost(arch, shape_name)
    finally:
        jax.jit = jit
    return cost, [hlo_parts(t) for t in texts]


def extrapolate(arch: str, shape_name: str, parts, prefix: str) -> float:
    """The FLOPs of the HLO opcodes starting with ``prefix`` in the
    reference's full-depth count: its extrapolation from depths 1 and 2,
    times the micro-batches and plus the optimizer for train."""
    cfg = get_config(arch)
    shape = cfg.shapes()[shape_name]

    def part(p):
        return sum(v for k, v in p.items() if k.startswith(prefix))

    f1, f2 = part(parts[0]), part(parts[1])
    full = f1 + (f2 - f1) * (cfg.n_periods - 1)
    if shape.kind != "train":
        return full
    gb = shape.global_batch
    return full * (gb // min(cfg.microbatch or gb, gb)) + part(parts[2])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--periods", type=int, default=None,
                    help="split one compile at this depth (default: the "
                         "reference's full-depth analytic count)")
    args = ap.parse_args()
    if args.periods is None:
        from repro_torch.launch.cells import analytic_cost
        cost, parts = analytic_parts(args.arch, args.shape)
        total = cost["flops"]
        dot = extrapolate(args.arch, args.shape, parts, "dot")
        conv = extrapolate(args.arch, args.shape, parts, "convert")
        port = analytic_cost(args.arch, args.shape)
        print(json.dumps({
            "arch": args.arch, "shape": args.shape, "reference": total,
            "reference_dot": dot, "reference_convert": conv,
            "reference_other": total - dot - conv,
            "convert_share": conv / total, "port": port["flops"],
            "port_products": port["products"],
            "port_elementwise": port["elementwise"],
            "port_over_reference": port["flops"] / total,
            "port_over_reference_less_convert":
                port["flops"] / (total - conv),
            "products_over_dot": port["products"] / dot}))
        return
    total, parts = reference(args.arch, args.shape, args.periods)
    parsed = sum(parts.values())
    print(f"reference {args.arch} {args.shape} at {args.periods} period(s):"
          f" cost_analysis flops {total:.4e}, parsed {parsed:.4e} "
          f"({parsed / total:.5f})")
    for op, f in parts.most_common():
        print(f"  {op:32s} {f:.4e}  {f / total:.4f}")
    c = port(args.arch, args.shape, args.periods)
    flops = c.products + c.elementwise
    print(f"port: flops {flops:.4e} (products {c.products:.4e}, "
          f"elementwise {c.elementwise:.4e}); port / reference "
          f"{flops / total:.4f}")
    for op, f in c.by_op.most_common(12):
        if f:
            print(f"  {op:32s} {f:.4e}  {f / flops:.4f}")


if __name__ == "__main__":
    main()
