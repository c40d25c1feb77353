"""Decoder LM assembly: the counterpart of ``repro.models.transformer``
for dense self-attention models (gemma2, smollm, qwen), Mixture-of-Experts
models (granite-moe, grok-1) and Mamba2 SSM models (mamba2).

``Model`` is an ``nn.Module`` that holds its weights with the JAX
package's parameter tree as its state-dict names (``embed``,
``final_norm``, ``blocks.l{i}.norm1``, ``blocks.l{i}.mix.wq``, …), each
block parameter stacked over the ``n_periods`` repetitions of the
config's layer pattern, so ``convert.params_from_jax`` output loads with
``load_state_dict``. The layers run as a Python loop over periods: the
same math as the reference's ``lax.scan``.

Entry points:
  * ``init(seed)``                   — random weights from an explicit
                                       generator, in place; returns self
  * ``init_cache(batch, max_len)``   — the stacked KV caches
  * ``prefill(batch, cache)``        — fills the caches, last-token logits
  * ``decode(tokens, cache, pos)``   — one serve step

``impl="cuda"`` runs attention through the flash-attention and
flash-decode kernels and the Mamba2 scan through the SSD kernel
(``kernels/ops``), ``impl="torch"`` through the plain tensor path;
``None`` picks ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU
(``compat.resolve_backend``); ``"cuda"`` on the CPU calls the kernels'
wrappers, which run their plain versions on CPU tensors. Caches are updated in place; Mamba caches are float32 whatever the cache
dtype asked for, as in the reference.

Not ported yet (raise ``NotImplementedError``): the hybrid jamba stack,
cross-attention (vlm / audio), encoders, and the training ``loss``
(ROADMAP, queued work of the port).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.compat import Device, resolve_backend, resolve_device
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, DENSE, MAMBA, MOE,
                                      NONE, ArchConfig, LayerSpec)
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models import mlp as F
from repro_torch.models.common import KeyGen, normal_init, rms_norm, softcap

__all__ = ["Model"]


def _unsupported(cfg: ArchConfig, pattern) -> Optional[str]:
    if cfg.encoder_layers:
        return "encoder-decoder models (whisper)"
    if cfg.family == "hybrid":
        return "the hybrid attention / Mamba / MoE stack (jamba)"
    for sp in pattern:
        if sp.mixer not in (ATTN, ATTN_LOCAL, MAMBA):
            return f"the {sp.mixer!r} mixer (cross-attention)"
        if sp.cross:
            return "cross-attention sublayers"
        if sp.mlp not in (DENSE, MOE, NONE):
            return f"the {sp.mlp!r} MLP"
    return None


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Layer(nn.Module):
    """One layer of the period block, its tensors stacked over periods."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        n, d = cfg.n_periods, cfg.d_model
        self.norm1 = _param((n, d), torch.float32, device)
        if spec.mixer == MAMBA:
            mix = {name: (shape, torch.float32 if name in M.F32_PARAMS
                          else dtype)
                   for name, (shape, _) in M.mamba_shapes(cfg).items()}
        else:
            mix = {name: (shape, dtype)
                   for name, (shape, _) in A.attn_shapes(cfg).items()}
        self.mix = nn.ParameterDict({
            name: _param((n,) + shape, dt, device)
            for name, (shape, dt) in mix.items()})
        if spec.mlp != NONE:
            shapes = (F.moe_mlp_shapes(cfg) if spec.mlp == MOE
                      else F.dense_mlp_shapes(cfg))
            self.norm2 = _param((n, d), torch.float32, device)
            self.mlp = nn.ParameterDict({
                name: _param((n,) + shape, F.ROUTER_DTYPE
                             if name == "router" else dtype, device)
                for name, (shape, _) in shapes.items()})


def _tree(module: nn.Module) -> Dict:
    """The module's parameters as the JAX package's nested dict."""
    out: Dict = {}
    for name, p in module.named_parameters():
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


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device: Device = None,
                 impl: Optional[str] = None,
                 compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = resolve_backend(impl, self.device, plain_on_cpu=True)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.pattern = cfg.layer_pattern()
        missing = _unsupported(cfg, self.pattern)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported yet (ROADMAP, queued "
                f"work of the port); the port runs dense and MoE "
                f"self-attention models and Mamba2 models")
        dev = self.device
        self.embed = _param((cfg.vocab, cfg.d_model), param_dtype, dev)
        self.final_norm = _param((cfg.d_model,), torch.float32, dev)
        self.blocks = nn.ModuleDict({
            f"l{i}": _Layer(cfg, sp, param_dtype, dev)
            for i, sp in enumerate(self.pattern)})

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
        ``seed`` on the model's device, period by period, as the
        reference's initialisers do: truncated-normal matrices with the
        reference's standard deviations, zero norms and biases, and the
        Mamba layers' deterministic ``A_log``, ``D`` and ``dt_bias``. The
        numbers differ from the JAX package's ``Model.init(seed)``; the
        tests load those through ``convert.params_from_jax``."""
        kg = KeyGen(seed, self.device)
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        self.embed.copy_(normal_init(kg(), self.embed.shape,
                                     cfg.d_model ** -0.5, dt, dev))
        for name, t in self.named_parameters():
            if "norm" in name:
                t.zero_()
        for layer, sp in zip(self.blocks.values(), self.pattern):
            init_mix = M.init_mamba if sp.mixer == MAMBA else A.init_attn
            for i in range(cfg.n_periods):
                for name, t in init_mix(kg, cfg, dt, dev).items():
                    layer.mix[name][i].copy_(t)
                if hasattr(layer, "mlp"):
                    init_mlp = F.init_moe if sp.mlp == MOE \
                        else F.init_dense_mlp
                    for name, t in init_mlp(kg, cfg, dt, dev).items():
                        layer.mlp[name][i].copy_(t)
        return self

    def params(self) -> Dict:
        """The weights as the JAX package's nested parameter dict."""
        return _tree(self)

    # ------------------------------------------------------------- caches

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Dict:
        """Attention layers: K/V caches of ``max_len`` in ``dtype``;
        Mamba layers: the SSM state and conv tails in float32."""
        n = self.cfg.n_periods

        def layer(sp):
            if sp.mixer == MAMBA:
                return M.init_mamba_cache(self.cfg, batch, torch.float32,
                                          "meta")
            return A.init_cache(self.cfg, batch, max_len, dtype, "meta")

        return {f"l{i}": {name: torch.zeros((n,) + t.shape, dtype=t.dtype,
                                            device=self.device)
                          for name, t in layer(sp).items()}
                for i, sp in enumerate(self.pattern)}

    # ------------------------------------------------------------ forward

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params, tokens):
        x = params["embed"][tokens].to(self.compute_dtype)
        return x * torch.tensor(self.cfg.d_model ** 0.5,
                                dtype=self.compute_dtype, device=x.device)

    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"])
        logits = torch.einsum("bsd,vd->bsv", x,
                              params["embed"].to(self.compute_dtype)
                              .to(x.dtype))
        return softcap(logits, self.cfg.final_softcap)

    def _mixer(self, lp, spec: LayerSpec, h, mode, cache, pos):
        if spec.mixer == MAMBA:
            if mode == "full":
                return M.mamba_full(lp["mix"], h, self.cfg,
                                    self.impl), cache
            if mode == "prefill":
                return M.mamba_prefill(lp["mix"], h, self.cfg, cache,
                                       self.impl)
            return M.mamba_decode(lp["mix"], h, self.cfg, cache)
        local = spec.mixer == ATTN_LOCAL
        if mode == "full":
            return A.attend_full(lp["mix"], h, self.cfg, local,
                                 self.impl), cache
        if mode == "prefill":
            return A.prefill_attn(lp["mix"], h, self.cfg, cache, local,
                                  self.impl)
        return A.decode_attn(lp["mix"], h, self.cfg, cache, pos, local,
                             self.impl)

    def _block(self, x, blk, spec_cache, mode, pos):
        """One period block. blk / spec_cache: per-period slices."""
        for i, sp in enumerate(self.pattern):
            lp = blk[f"l{i}"]
            lc = spec_cache[f"l{i}"] if spec_cache is not None else None
            h = rms_norm(x, lp["norm1"])
            out, _ = self._mixer(lp, sp, h, mode, lc, pos)
            x = x + out
            if sp.mlp != NONE:
                h2 = rms_norm(x, lp["norm2"])
                x = x + (F.moe_mlp(lp["mlp"], h2, self.cfg)
                         if sp.mlp == MOE else F.dense_mlp(lp["mlp"], h2))
        return x

    def _run_blocks(self, params, x, mode, cache=None, pos=None):
        for i in range(self.cfg.n_periods):
            cb = _index(cache, i) if cache is not None else None
            x = self._block(x, _index(params["blocks"], i), cb, mode, pos)
        return x, cache

    # -------------------------------------------------------- entry points

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits (b, s, vocab), no cache."""
        params = self.params()
        x, _ = self._run_blocks(params, self._embed(params,
                                                    self._tokens(tokens)),
                                "full")
        return self._logits(params, x)

    @torch.no_grad()
    def prefill(self, batch: Dict, cache: Dict):
        """``batch["tokens"]`` (b, s) → last-token logits (b, 1, vocab)
        and the cache (rows [0, s) written in place)."""
        params = self.params()
        x = self._embed(params, self._tokens(batch["tokens"]))
        x, cache = self._run_blocks(params, x, "prefill", cache=cache)
        return self._logits(params, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict, pos):
        """tokens: (b, 1); pos: a scalar (one shared write position; an
        int or 0-d tensor) or (b,) per-row positions (continuous
        batching). Returns logits (b, 1, vocab) and the cache."""
        params = self.params()
        x = self._embed(params, self._tokens(tokens))
        x, cache = self._run_blocks(params, x, "decode", cache=cache,
                                    pos=pos)
        return self._logits(params, x), cache

    def loss(self, *args, **kwargs):
        raise NotImplementedError(
            "Model.loss: training is not ported yet (ROADMAP, queued work "
            "of the port: train/)")
