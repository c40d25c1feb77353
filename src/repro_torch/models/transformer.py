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

Not ported yet (raises ``NotImplementedError``): the training ``loss``
(ROADMAP, queued work of the port).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.compat import Device, resolve_backend, resolve_device
from repro_torch.configs.base import (ATTN, ATTN_CROSS, ATTN_LOCAL, DENSE,
                                      MAMBA, MOE, NONE, ArchConfig,
                                      LayerSpec)
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models import mlp as F
from repro_torch.models.common import KeyGen, normal_init, rms_norm, softcap

__all__ = ["Model"]


ENCODER_SPEC = LayerSpec(ATTN, DENSE)
FRONTEND_FAMILIES = ("vlm", "audio")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Layer(nn.Module):
    """One layer of the period block, its tensors stacked over ``n``
    repetitions (the periods, or the encoder's layers)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype, device,
                 n: int):
        super().__init__()
        d = cfg.d_model
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
        if spec.cross:
            self.norm_cross = _param((n, d), torch.float32, device)
            self.cross = nn.ParameterDict({
                name: _param((n,) + shape, dtype, device)
                for name, (shape, _) in A.attn_shapes(cfg).items()})
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


class _Encoder(nn.Module):
    """Whisper's encoder: ``encoder_layers`` self-attention + dense MLP
    layers stacked in ``blocks``, then ``norm``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.blocks = _Layer(cfg, ENCODER_SPEC, dtype, device,
                             cfg.encoder_layers)
        self.norm = _param((cfg.d_model,), torch.float32, device)


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
        dev = self.device
        self.embed = _param((cfg.vocab, cfg.d_model), param_dtype, dev)
        self.final_norm = _param((cfg.d_model,), torch.float32, dev)
        self.blocks = nn.ModuleDict({
            f"l{i}": _Layer(cfg, sp, param_dtype, dev, cfg.n_periods)
            for i, sp in enumerate(self.pattern)})
        if cfg.encoder_layers:
            self.encoder = _Encoder(cfg, param_dtype, dev)
        if cfg.family == "vlm":
            self.front_norm = _param((cfg.d_model,), torch.float32, dev)

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

    def params(self) -> Dict:
        """The weights as the JAX package's nested parameter dict."""
        return _tree(self)

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
            if sp.mixer == MAMBA:
                return M.init_mamba_cache(cfg, batch, torch.float32, "meta")
            cross_len = cfg.frontend_len if sp.cross or \
                sp.mixer == ATTN_CROSS else 0
            c = A.init_cache(cfg, batch, max_len, cross_len, dtype, "meta")
            if sp.mixer == ATTN_CROSS:
                del c["k"], c["v"]
            return c

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
            h = rms_norm(x, lp["norm1"])
            out, _ = self._mixer(lp, sp, h, mode, mix_c, pos, src)
            x = x + out
            if sp.cross:
                hc = rms_norm(x, lp["norm_cross"])
                x = x + self._cross(lp["cross"], hc, mode, cross_c, src)
            if sp.mlp != NONE:
                h2 = rms_norm(x, lp["norm2"])
                x = x + (F.moe_mlp(lp["mlp"], h2, self.cfg)
                         if sp.mlp == MOE else F.dense_mlp(lp["mlp"], h2))
        return x

    def _run_blocks(self, params, x, mode, cache=None, pos=None, src=None):
        for i in range(self.cfg.n_periods):
            cb = _index(cache, i) if cache is not None else None
            x = self._block(x, _index(params["blocks"], i), cb, mode, pos,
                            src)
        return x, cache

    def _encode(self, params, frames):
        x = torch.as_tensor(frames, device=self.device).to(
            self.compute_dtype)
        enc = params["encoder"]
        for i in range(self.cfg.encoder_layers):
            blk = _index(enc["blocks"], i)
            h = rms_norm(x, blk["norm1"])
            x = x + A.attend_full(blk["mix"], h, self.cfg, local=False,
                                  impl="torch", causal=False)
            h2 = rms_norm(x, blk["norm2"])
            x = x + F.dense_mlp(blk["mlp"], h2)
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
        front = torch.as_tensor(front, device=self.device)
        return rms_norm(front.to(self.compute_dtype), params["front_norm"])

    # -------------------------------------------------------- entry points

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over stub frame embeddings (b, F, d): the
        bidirectional self-attention layers (plain path) and the final
        norm, in the compute dtype."""
        return self._encode(self.params(), frames)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (b, s, vocab), no cache; ``frontend`` as
        ``batch["frontend"]`` of ``prefill``."""
        params = self.params()
        src = self._frontend(params, {"frontend": frontend})
        x, _ = self._run_blocks(params, self._embed(params,
                                                    self._tokens(tokens)),
                                "full", src=src)
        return self._logits(params, x)

    @torch.no_grad()
    def prefill(self, batch: Dict, cache: Dict):
        """``batch["tokens"]`` (b, s) → last-token logits (b, 1, vocab)
        and the cache (rows [0, s) written in place; ``ck`` / ``cv`` from
        ``batch["frontend"]``, which vlm and audio models need)."""
        params = self.params()
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
        x = self._embed(params, self._tokens(tokens))
        x, cache = self._run_blocks(params, x, "decode", cache=cache,
                                    pos=pos)
        return self._logits(params, x), cache

    def loss(self, *args, **kwargs):
        raise NotImplementedError(
            "Model.loss: training is not ported yet (ROADMAP, queued work "
            "of the port: train/)")
