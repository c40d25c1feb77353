"""Model assembly: the counterpart of ``repro.models.transformer`` for
every architecture family of the configs: dense self-attention models
(gemma2, smollm, qwen), Mixture-of-Experts models (granite-moe, grok-1),
Mamba2 SSM models (mamba2), the hybrid attention / Mamba2 / MoE stack
(jamba), vision-language models with cross-attention layers
(llama-3.2-vision) and the encoder-decoder audio model (whisper).

``Model`` is an ``nn.Module`` that holds its weights with the JAX
package's parameter tree as its state-dict names (``embed``,
``final_norm``, ``blocks.l{i}.norm1``, ``blocks.l{i}.mix.wq``,
``blocks.l{i}.norm_cross``, ``encoder.blocks.mix.wq``,
``encoder.norm``, ``front_norm``, …), each block parameter stacked over
the ``n_periods`` repetitions of the config's layer pattern (the
encoder's over its ``encoder_layers``), so ``convert.params_from_jax``
output loads with ``load_state_dict``. The layers run as a Python loop
over periods: the same math as the reference's ``lax.scan``.

Entry points:
  * ``init(seed)``                   — random weights from an explicit
                                       generator, in place; returns self
  * ``init_cache(batch, max_len)``   — the stacked KV / SSM caches, and
                                       the cross-attention ``ck`` / ``cv``
                                       of ``frontend_len``
  * ``prefill(batch, cache)``        — fills the caches, last-token logits
  * ``decode(tokens, cache, pos)``   — one serve step
  * ``encode(frames)``               — whisper's encoder
  * ``loss(batch)``                  — the training loss, differentiable

vlm and audio models read ``batch["frontend"]`` (b, frontend_len,
d_model), the stub frontend's patch or frame embeddings: the vlm's go
through ``front_norm``, the audio model's through the encoder, and the
cross-attention layers attend to the result. Without it they raise
``ValueError``.

``impl="cuda"`` runs self-attention through the flash-attention and
flash-decode kernels and the Mamba2 scan through the SSD kernel
(``kernels/ops``), ``impl="torch"`` through the plain tensor path;
``None`` picks ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU
(``compat.resolve_backend``); ``"cuda"`` on the CPU calls the kernels'
wrappers, which run their plain versions on CPU tensors.
Cross-attention and the encoder run the plain path under either impl,
as in the reference. Caches are updated in place; Mamba caches are
float32 whatever the cache dtype asked for, as in the reference.

On a layout of several devices (``Model(cfg, layout)`` with a
``launch.mesh.Layout`` that holds a ``DeviceMesh``) every weight is a
DTensor placed by ``param_specs`` (the reference's specs: each rank
holds only its shards), caches are placed by ``cache_pspecs`` and inputs
are sharded over the batch axes. Each layer (attention, MLP, MoE,
Mamba2, the embedding, the logits and the loss) runs per rank through
``local_map`` (``common.per_rank``): rows over the batch axes, heads,
``d_ff`` or the vocabulary over ``"model"`` where they divide it, with
the reference's ``psum`` as an all-reduce of each rank's partial sum;
the norms and residual adds between them run under DTensor's sharding
propagation, the reference's ``with_sharding_constraint`` sites as
``common.shard``. Plain tensors met there (masks, positions) are taken
as replicated. Off a mesh the model holds plain tensors, as before.

Weights are created with ``requires_grad=False``, so serving builds no
autograd graph; a trainer calls ``requires_grad_(True)`` on its own
model. ``loss`` runs the ``"full"`` mode with grad enabled and, where
``cfg.remat`` is set (the config default), recomputes each period in the
backward pass (``torch.utils.checkpoint``), as the reference wraps each
period in ``jax.checkpoint``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import Device, resolve_backend, resolve_device
from repro_torch.configs.base import (ATTN, ATTN_CROSS, ATTN_LOCAL, DENSE,
                                      MAMBA, MOE, NONE, ArchConfig,
                                      LayerSpec)
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models import mlp as F
from repro_torch.models.common import (AxisSizes, KeyGen, all_reduce_fwd,
                                       axes_of, batch_split,
                                       cross_entropy_loss, is_dtensor,
                                       normal_init, per_rank, placed_empty,
                                       placed_zeros, rms_norm, settled,
                                       shard,
                                       softcap, split_axis, upcast)

__all__ = ["Model"]


ENCODER_SPEC = LayerSpec(ATTN, DENSE)
FRONTEND_FAMILIES = ("vlm", "audio")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _prepend(spec, dim=None):
    """A layer's specs with the stacked (period) dimension in front."""
    if isinstance(spec, dict):
        return {k: _prepend(v, dim) for k, v in spec.items()}
    return (dim,) + tuple(spec)


def _flat(tree, prefix: str = "") -> Dict:
    """A nested dict as ``{"blocks.l0.mix.wq": leaf, …}``."""
    out: Dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _Layer(nn.Module):
    """One layer of the period block, its tensors stacked over ``n``
    repetitions (the periods, or the encoder's layers). ``make(name,
    shape, dtype)`` creates each parameter (``name`` relative to the
    layer)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype,
                 make: Callable, n: int):
        super().__init__()
        d = cfg.d_model
        self.norm1 = make("norm1", (n, d), torch.float32)
        if spec.mixer == MAMBA:
            mix = {name: (shape, torch.float32 if name in M.F32_PARAMS
                          else dtype)
                   for name, (shape, _) in M.mamba_shapes(cfg).items()}
        else:
            mix = {name: (shape, dtype)
                   for name, (shape, _) in A.attn_shapes(cfg).items()}
        self.mix = nn.ParameterDict({
            name: make(f"mix.{name}", (n,) + shape, dt)
            for name, (shape, dt) in mix.items()})
        if spec.cross:
            self.norm_cross = make("norm_cross", (n, d), torch.float32)
            self.cross = nn.ParameterDict({
                name: make(f"cross.{name}", (n,) + shape, dtype)
                for name, (shape, _) in A.attn_shapes(cfg).items()})
        if spec.mlp != NONE:
            shapes = (F.moe_mlp_shapes(cfg) if spec.mlp == MOE
                      else F.dense_mlp_shapes(cfg))
            self.norm2 = make("norm2", (n, d), torch.float32)
            self.mlp = nn.ParameterDict({
                name: make(f"mlp.{name}", (n,) + shape, F.ROUTER_DTYPE
                           if name == "router" else dtype)
                for name, (shape, _) in shapes.items()})


def _tree(module: nn.Module) -> Dict:
    """The module's parameters as the JAX package's nested dict."""
    return _tree_of(dict(module.named_parameters()))


def _tree_of(named: Dict[str, torch.Tensor]) -> Dict:
    """``{"blocks.l0.mix.wq": t, …}`` → the nested dict."""
    out: Dict = {}
    for name, p in named.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return out


def _index(tree, i: int):
    """Period ``i`` of a stacked tree (views, so cache writes land in
    the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int):
    """The ``n`` periods of a stacked parameter tree, as views. One
    ``unbind`` per tensor: its backward stacks the periods' gradients
    once, where indexing each period would add a full-size gradient per
    period."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(tree, 0)


class _Encoder(nn.Module):
    """Whisper's encoder: ``encoder_layers`` self-attention + dense MLP
    layers stacked in ``blocks``, then ``norm``."""

    def __init__(self, cfg: ArchConfig, dtype, make: Callable):
        super().__init__()
        self.blocks = _Layer(cfg, ENCODER_SPEC, dtype,
                             lambda n, *a: make(f"blocks.{n}", *a),
                             cfg.encoder_layers)
        self.norm = make("norm", (cfg.d_model,), torch.float32)


class Model(nn.Module):
    """``layout`` is a device (``compat.resolve_device``: the card by
    default) or a ``launch.mesh.Layout``: one with a ``DeviceMesh``
    places every weight as a DTensor by ``param_specs``; one without
    (``make_local_mesh``) is its device."""

    def __init__(self, cfg: ArchConfig, layout: Union[Device, object] = None,
                 impl: Optional[str] = None,
                 compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.pattern = cfg.layer_pattern()
        if hasattr(layout, "axes"):
            if layout.device is None:
                raise ValueError(
                    f"layout {layout.shape} has no devices: it needs a "
                    f"process group of {layout.size} ranks")
            self.device = layout.device
            self.ax = AxisSizes.from_mesh(layout)
        else:
            self.device = resolve_device(layout)
            self.ax = AxisSizes.single()
        self.impl = resolve_backend(impl, self.device, plain_on_cpu=True)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        specs = _flat(self.param_specs()) if self.ax.mesh is not None \
            else None

        def make(name, shape, dtype):
            if specs is None:
                return _param(shape, dtype, self.device)
            return nn.Parameter(placed_empty(
                shape, dtype, self.device, self.ax.mesh,
                self.ax.placements(specs[name])), requires_grad=False)

        self.embed = make("embed", (cfg.vocab, cfg.d_model), param_dtype)
        self.final_norm = make("final_norm", (cfg.d_model,), torch.float32)
        self.blocks = nn.ModuleDict({
            f"l{i}": _Layer(cfg, sp, param_dtype,
                            lambda n, *a, i=i: make(f"blocks.l{i}.{n}", *a),
                            cfg.n_periods)
            for i, sp in enumerate(self.pattern)})
        if cfg.encoder_layers:
            self.encoder = _Encoder(cfg, param_dtype,
                                    lambda n, *a: make(f"encoder.{n}", *a))
        if cfg.family == "vlm":
            self.front_norm = make("front_norm", (cfg.d_model,),
                                   torch.float32)

    @property
    def mesh(self):
        """The ``DeviceMesh`` the weights are placed on, or ``None``."""
        return self.ax.mesh

    def sharded(self):
        """The context of a forward or backward pass on a mesh: plain
        tensors met by a DTensor op (masks, positions, and the masks the
        backward pass reads) are taken as replicated. A no-op off a
        mesh. The entry points enter it themselves; a caller enters it
        around ``loss(...).backward()``."""
        if self.ax.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    def with_impl(self, impl: str) -> "Model":
        """A view of this model (the same weight tensors) that runs
        ``impl``."""
        other = copy.copy(self)
        other.__dict__["impl"] = resolve_backend(impl, self.device,
                                                 plain_on_cpu=True)
        return other

    # ------------------------------------------------------------- params

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Fill every weight from one ``torch.Generator`` seeded with
        ``seed`` on the model's device, layer by layer and period by
        period (the decoder's blocks, then the encoder's), as the
        reference's initialisers do: truncated-normal matrices with the
        reference's standard deviations, zero norms and biases, and the
        Mamba layers' deterministic ``A_log``, ``D`` and ``dt_bias``. The
        numbers differ from the JAX package's ``Model.init(seed)``; the
        tests load those through ``convert.params_from_jax``."""
        if self.ax.mesh is not None:
            # Every rank draws the whole tree from the same generator,
            # as one device does, and keeps its shards.
            plain = Model(self.cfg, self.device, self.impl,
                          self.compute_dtype, self.param_dtype).init(seed)
            return self.place_(plain.state_dict())
        kg = KeyGen(seed, self.device)
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        self.embed.copy_(normal_init(kg(), self.embed.shape,
                                     cfg.d_model ** -0.5, dt, dev))
        for name, t in self.named_parameters():
            if "norm" in name:
                t.zero_()
        layers = list(zip(self.blocks.values(), self.pattern))
        if cfg.encoder_layers:
            layers.append((self.encoder.blocks, ENCODER_SPEC))
        for layer, sp in layers:
            init_mix = M.init_mamba if sp.mixer == MAMBA else A.init_attn
            init_mlp = F.init_moe if sp.mlp == MOE else F.init_dense_mlp
            for i in range(layer.norm1.shape[0]):
                parts = [(layer.mix, init_mix)]
                if sp.cross:
                    parts.append((layer.cross, A.init_attn))
                if sp.mlp != NONE:
                    parts.append((layer.mlp, init_mlp))
                for params, init_fn in parts:
                    for name, t in init_fn(kg, cfg, dt, dev).items():
                        params[name][i].copy_(t)
        return self

    @torch.no_grad()
    def place_(self, state: Dict[str, torch.Tensor]) -> "Model":
        """Loads whole tensors (``{"blocks.l0.mix.wq": t, …}``, e.g.
        ``convert.params_from_jax`` or another model's ``state_dict``),
        each rank keeping its shard of each; returns self."""
        for name, p in self.named_parameters():
            full = state[name]
            full = full.full_tensor() if is_dtensor(full) else full
            full = full.to(device=self.device, dtype=p.dtype)
            if is_dtensor(p):
                from torch.distributed.tensor import distribute_tensor
                p.to_local().copy_(distribute_tensor(
                    full, p.device_mesh, p.placements,
                    src_data_rank=None).to_local())
            else:
                p.copy_(full)
        return self

    def params(self) -> Dict:
        """The weights as the JAX package's nested parameter dict."""
        return _tree(self)

    # ------------------------------------------------------------- specs

    def _layer_specs(self, spec: LayerSpec) -> Dict:
        cfg, ax = self.cfg, self.ax
        s: Dict = {"norm1": (None,)}
        s["mix"] = M.mamba_specs(cfg, ax) if spec.mixer == MAMBA \
            else A.attn_specs(cfg, ax)
        if spec.cross:
            s["norm_cross"] = (None,)
            s["cross"] = A.attn_specs(cfg, ax)
        if spec.mlp != NONE:
            s["norm2"] = (None,)
            s["mlp"] = (F.dense_mlp_specs(cfg, ax) if spec.mlp == DENSE
                        else F.moe_specs(cfg, ax))
        return s

    def param_specs(self) -> Dict:
        """The reference's parameter specs: the parameter tree with a
        spec (a tuple of axis names, ``None`` or tuples of names, one
        per dimension) at each leaf."""
        cfg, ax = self.cfg, self.ax
        specs: Dict = {
            "embed": ax.spec(("model", "data"), (cfg.vocab, cfg.d_model)),
            "final_norm": (None,),
            "blocks": {
                f"l{i}": _prepend(self._layer_specs(sp))
                for i, sp in enumerate(self.pattern)
            },
        }
        if cfg.encoder_layers:
            specs["encoder"] = {
                "blocks": _prepend(self._layer_specs(ENCODER_SPEC)),
                "norm": (None,),
            }
        if cfg.family == "vlm":
            specs["front_norm"] = (None,)
        return specs

    def cache_pspecs(self, cache: Dict) -> Dict:
        """The reference's key-aware cache specs (``cache``: the cache
        tree, or the same tree with each leaf's shape).

        KV caches (period, batch, kv_heads, seq, hd): batch over the
        batch axes when divisible; otherwise (batch-1 long-context
        cells) the *sequence* dim is sharded — over 'data', and also
        over 'model' when the kv-head count doesn't divide the model
        axis. SSM states shard heads over 'model'; conv tails shard
        channels."""
        ax = self.ax

        def kv_spec(shape):
            per, b, kv, s, hd = shape
            batch_ok = b % ax.size(ax.batch_axes) == 0 and \
                ax.size(ax.batch_axes) > 1
            heads_ok = kv % ax.size("model") == 0 and ax.size("model") > 1
            if batch_ok:
                return ax.spec((None, ax.batch_axes,
                                "model" if heads_ok else None, None, None),
                               shape)
            seq_axes = ("data",) if heads_ok else ("data", "model")
            if ax.has("pod"):
                seq_axes = ("pod",) + seq_axes
            return ax.spec((None, None, "model" if heads_ok else None,
                            seq_axes, None), shape)

        def spec_of(key, a):
            shape = tuple(getattr(a, "shape", a))
            if key in ("k", "v", "ck", "cv"):
                return kv_spec(shape)
            if key == "state":       # (period, b, nh, p, n)
                return ax.spec((None, ax.batch_axes, "model", None, None),
                               shape)
            if key in ("conv_x", "conv_bc"):   # (period, b, w-1, ch)
                return ax.spec((None, ax.batch_axes, None, "model"), shape)
            return ax.spec((None, ax.batch_axes) + (None,) * (len(shape)
                                                              - 2), shape)

        def walk(node):
            return {k: walk(v) if isinstance(v, dict) else spec_of(k, v)
                    for k, v in node.items()}

        return walk(cache)

    # ------------------------------------------------------------- caches

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Dict:
        """Self-attention layers: K/V caches of ``max_len`` in
        ``dtype``; cross-attention (an ``ATTN_CROSS`` mixer or a
        ``cross`` sublayer): ``ck`` / ``cv`` of ``frontend_len`` in
        ``dtype``; Mamba layers: the SSM state and conv tails in
        float32."""
        cfg, n = self.cfg, self.cfg.n_periods

        def layer(sp):
            """name → (shape, dtype) of one layer's cache."""
            if sp.mixer == MAMBA:
                return {name: (shape, torch.float32) for name, shape in
                        M.mamba_cache_shapes(cfg, batch).items()}
            cross_len = cfg.frontend_len if sp.cross or \
                sp.mixer == ATTN_CROSS else 0
            c = A.cache_shapes(cfg, batch, max_len, cross_len)
            if sp.mixer == ATTN_CROSS:
                del c["k"], c["v"]
            return {name: (shape, dtype) for name, shape in c.items()}

        shapes = {f"l{i}": {name: ((n,) + shape, dt)
                            for name, (shape, dt) in layer(sp).items()}
                  for i, sp in enumerate(self.pattern)}
        if self.ax.mesh is not None:
            specs = self.cache_pspecs(
                {li: {k: shape for k, (shape, _) in lc.items()}
                 for li, lc in shapes.items()})
            return {li: {k: placed_zeros(shape, dt, self.device,
                                         self.ax.mesh,
                                         self.ax.placements(specs[li][k]))
                         for k, (shape, dt) in lc.items()}
                    for li, lc in shapes.items()}
        return {li: {k: torch.zeros(shape, dtype=dt, device=self.device)
                     for k, (shape, dt) in lc.items()}
                for li, lc in shapes.items()}

    # ------------------------------------------------------------ forward

    def _input(self, t) -> torch.Tensor:
        """An input tensor on the model's device; on a mesh, a plain
        tensor (the whole batch, the same on every rank) becomes a
        DTensor sharded over the batch axes where they divide it."""
        if is_dtensor(t):
            return t
        t = torch.as_tensor(t, device=self.device)
        if self.ax.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        ax = self.ax
        spec = ax.spec((ax.batch_axes,) + (None,) * (t.dim() - 1), t.shape)
        return distribute_tensor(t, ax.mesh, ax.placements(spec),
                                 src_data_rank=None)

    def _tokens(self, tokens) -> torch.Tensor:
        return self._input(tokens).long()

    def _embed(self, params, tokens):
        embed = params["embed"]
        if is_dtensor(tokens):
            x = self._embed_per_rank(embed, tokens)
        else:
            x = embed[tokens]
        x = x.to(self.compute_dtype)
        return x * torch.tensor(self.cfg.d_model ** 0.5,
                                dtype=self.compute_dtype, device=x.device)

    def _vocab_split(self, tokens):
        """(the mesh axes, the rows' axes, the vocabulary's axis): the
        vocabulary over "model" where it divides it (the embedding's
        spec), else whole on each rank."""
        ax = axes_of(tokens)
        return ax, batch_split(ax, tokens.shape[0]), \
            split_axis(ax, self.cfg.vocab)

    def _embed_per_rank(self, embed, tokens):
        """The lookup per rank: each rank holds a slice of the vocabulary
        and looks up the tokens that fall in it (0 for the others); the
        result is its partial sum over "model"."""
        ax, bt, vx = self._vocab_split(tokens)

        def body(tok, emb):
            if vx is None:
                return emb[tok]
            lo = ax.mesh.get_local_rank(vx) * emb.shape[0]
            mine = (tok >= lo) & (tok < lo + emb.shape[0])
            rows = emb[(tok - lo).clamp(0, emb.shape[0] - 1)]
            return torch.where(mine[..., None], rows, torch.zeros(
                (), dtype=rows.dtype, device=rows.device))

        return per_rank(body, ax, (tokens, embed),
                        [(bt, None), (vx, None)], [(bt, None, None)],
                        partial=[vx])

    def _logits(self, params, x):
        x = settled(rms_norm(x, params["final_norm"]))
        embed = params["embed"].to(self.compute_dtype)
        if is_dtensor(x):
            # Per rank: each rank's rows against its slice of the
            # vocabulary (the logits stay sharded over "model").
            ax, bt, vx = self._vocab_split(x)
            logits = per_rank(
                lambda x_, e: torch.einsum("bsd,vd->bsv", x_, e.to(x_.dtype)),
                ax, (x, embed), [(bt, None, None), (vx, None)],
                [(bt, None, vx)])
        else:
            logits = torch.einsum("bsd,vd->bsv", x, embed.to(x.dtype))
        logits = shard(logits, self.ax, (self.ax.batch_axes, None, "model"))
        return softcap(logits, self.cfg.final_softcap)

    def _loss(self, logits, labels):
        """Mean token cross-entropy. On a mesh, per rank over its rows and
        its slice of the vocabulary: the max, the sum of exponentials and
        the gold logit are combined over "model". Each batch rank's mean
        over its rows, divided by the batch ranks, is its partial sum of
        the loss: its gradient is then its share of the mean's (an
        average placement would hand each rank the whole mean's
        gradient, and the batch ranks' sum would be that many times
        too large)."""
        if not is_dtensor(logits):
            return cross_entropy_loss(logits, labels)
        ax, bt, vx = self._vocab_split(logits)
        group = ax.mesh.get_group(vx) if vx is not None else None
        ranks = ax.size(bt) if bt is not None else 1

        def body(lg, lb):
            if group is None:
                return cross_entropy_loss(lg, lb) / ranks
            lg = lg.to(upcast(lg.dtype))
            m = all_reduce_fwd(lg.detach().amax(-1, keepdim=True), group,
                               op="max")
            se = all_reduce_fwd(torch.exp(lg - m).sum(-1), group)
            logz = m[..., 0] + torch.log(se)
            lo = ax.mesh.get_local_rank(vx) * lg.shape[-1]
            mine = (lb >= lo) & (lb < lo + lg.shape[-1])
            gold = torch.gather(lg, -1, (lb - lo).clamp(
                0, lg.shape[-1] - 1)[..., None].long())[..., 0]
            gold = all_reduce_fwd(torch.where(mine, gold, torch.zeros(
                (), dtype=gold.dtype, device=gold.device)), group)
            return torch.mean(logz - gold) / ranks

        return per_rank(body, ax, (logits, labels),
                        [(bt, None, vx), (bt, None)], [()], partial=[bt])

    def _mixer(self, lp, spec: LayerSpec, h, mode, cache, pos, src):
        cfg = self.cfg
        if spec.mixer == MAMBA:
            if mode == "full":
                return M.mamba_full(lp["mix"], h, cfg, self.impl), cache
            if mode == "prefill":
                return M.mamba_prefill(lp["mix"], h, cfg, cache, self.impl)
            return M.mamba_decode(lp["mix"], h, cfg, cache)
        if spec.mixer == ATTN_CROSS:
            return self._cross(lp["mix"], h, mode, cache, src), cache
        local = spec.mixer == ATTN_LOCAL
        if mode == "full":
            return A.attend_full(lp["mix"], h, cfg, local, self.impl), cache
        if mode == "prefill":
            return A.prefill_attn(lp["mix"], h, cfg, cache, local,
                                  self.impl)
        return A.decode_attn(lp["mix"], h, cfg, cache, pos, local,
                             self.impl)

    def _cross(self, p, h, mode, cache, src):
        """Cross-attention: to ``src`` in full and prefill modes (prefill
        also fills ``ck`` / ``cv``), to the cached K/V in decode."""
        if mode == "decode":
            return A.decode_cross_attn(p, h, self.cfg, cache)
        if mode == "prefill":
            A.fill_cross_cache(p, src, self.cfg, cache)
        return A.attend_cross(p, h, src, self.cfg)

    def _block(self, x, blk, spec_cache, mode, pos, src):
        """One period block. blk / spec_cache: per-period slices. A layer
        with a cross sublayer splits its cache: ``k`` / ``v`` for the
        mixer, ``ck`` / ``cv`` for the cross-attention."""
        for i, sp in enumerate(self.pattern):
            lp = blk[f"l{i}"]
            lc = spec_cache[f"l{i}"] if spec_cache is not None else None
            mix_c, cross_c = lc, lc
            if sp.cross and lc is not None:
                mix_c = {k: lc[k] for k in ("k", "v")}
                cross_c = {k: lc[k] for k in ("ck", "cv")}
            # On a mesh each sublayer's partial sums (and its input's
            # partial gradient) are combined at the sublayer, in the
            # compute dtype (``settled``), as GSPMD combines them.
            h = settled(rms_norm(x, lp["norm1"]))
            out, _ = self._mixer(lp, sp, h, mode, mix_c, pos, src)
            x = x + settled(out)
            if sp.cross:
                hc = settled(rms_norm(x, lp["norm_cross"]))
                x = x + settled(self._cross(lp["cross"], hc, mode,
                                            cross_c, src))
            if sp.mlp != NONE:
                h2 = settled(rms_norm(x, lp["norm2"]))
                x = x + settled(F.moe_mlp(lp["mlp"], h2, self.cfg, self.ax)
                                if sp.mlp == MOE
                                else F.dense_mlp(lp["mlp"], h2))
        return x

    def _block_sharded(self, *args):
        with self.sharded():
            return self._block(*args)

    def _run_blocks(self, params, x, mode, cache=None, pos=None, src=None):
        remat = self.cfg.remat and mode == "full" and \
            torch.is_grad_enabled()
        n = self.cfg.n_periods
        for i, blk in enumerate(_unbind(params["blocks"], n)):
            cb = _index(cache, i) if cache is not None else None
            if remat:
                # The recompute runs in the backward pass, outside the
                # entry point's context: the block enters it again.
                x = checkpoint(self._block_sharded, x, blk, cb, mode, pos,
                               src,
                               use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(x, blk, cb, mode, pos, src)
        return x, cache

    def _encode(self, params, frames):
        x = self._input(frames).to(self.compute_dtype)
        enc = params["encoder"]
        for blk in _unbind(enc["blocks"], self.cfg.encoder_layers):
            h = settled(rms_norm(x, blk["norm1"]))
            x = x + settled(A.attend_full(blk["mix"], h, self.cfg,
                                          local=False, impl="torch",
                                          causal=False))
            h2 = settled(rms_norm(x, blk["norm2"]))
            x = x + settled(F.dense_mlp(blk["mlp"], h2))
        return rms_norm(x, enc["norm"])

    def _frontend(self, params, batch):
        """The cross-attention source of a vlm / audio model: the
        frontend's embeddings through ``front_norm`` (vlm) or the encoder
        (audio); None for the other families."""
        cfg = self.cfg
        if cfg.family not in FRONTEND_FAMILIES:
            return None
        front = batch.get("frontend")
        if front is None:
            raise ValueError(
                f"{cfg.name}: a {cfg.family} model needs batch[\"frontend\"]"
                f", the (b, {cfg.frontend_len}, {cfg.d_model}) frontend "
                f"embeddings")
        if cfg.family == "audio":
            return self._encode(params, front)
        front = self._input(front)
        return rms_norm(front.to(self.compute_dtype), params["front_norm"])

    # -------------------------------------------------------- entry points

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over stub frame embeddings (b, F, d): the
        bidirectional self-attention layers (plain path) and the final
        norm, in the compute dtype."""
        with self.sharded():
            return self._encode(self.params(), frames)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (b, s, vocab), no cache; ``frontend`` as
        ``batch["frontend"]`` of ``prefill``."""
        params = self.params()
        with self.sharded():
            src = self._frontend(params, {"frontend": frontend})
            x, _ = self._run_blocks(params,
                                    self._embed(params, self._tokens(tokens)),
                                    "full", src=src)
            return self._logits(params, x)

    @torch.no_grad()
    def prefill(self, batch: Dict, cache: Dict):
        """``batch["tokens"]`` (b, s) → last-token logits (b, 1, vocab)
        and the cache (rows [0, s) written in place; ``ck`` / ``cv`` from
        ``batch["frontend"]``, which vlm and audio models need)."""
        params = self.params()
        with self.sharded():
            src = self._frontend(params, batch)
            x = self._embed(params, self._tokens(batch["tokens"]))
            x, cache = self._run_blocks(params, x, "prefill", cache=cache,
                                        src=src)
            return self._logits(params, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict, pos):
        """tokens: (b, 1); pos: a scalar (one shared write position; an
        int or 0-d tensor) or (b,) per-row positions (continuous
        batching). Returns logits (b, 1, vocab) and the cache."""
        params = self.params()
        with self.sharded():
            x = self._embed(params, self._tokens(tokens))
            x, cache = self._run_blocks(params, x, "decode", cache=cache,
                                        pos=pos)
            return self._logits(params, x), cache

    def loss(self, batch: Dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both (b, s); vlm / audio models also read
        ``batch["frontend"]``): the reference's ``loss``. float32 weights
        of more than one dimension run in the compute dtype; with grad
        enabled the result is differentiable in the weights that require
        it."""
        params = {name: p.to(self.compute_dtype)
                  if p.dtype == torch.float32 and p.ndim > 1 else p
                  for name, p in self.named_parameters()}
        params = _tree_of(params)
        with self.sharded():
            src = self._frontend(params, batch)
            x = self._embed(params, self._tokens(batch["tokens"]))
            x = shard(x, self.ax, (self.ax.batch_axes, None, None))
            x, _ = self._run_blocks(params, x, "full", src=src)
            return self._loss(self._logits(params, x),
                              self._tokens(batch["labels"]))
