"""Architecture configuration system.

Every assigned architecture is an ``ArchConfig`` registered under its id
and selectable via ``--arch`` in the launchers. A config fully determines:

  * the model structure (``layer_pattern()`` — the period block that the
    scan-over-layers iterates),
  * the shape grid (``shapes()`` — train/prefill/decode/long cells with
    the assignment's documented skips),
  * the provisioning demand model used by the PhoenixCloud layer
    (``train_chips`` / ``serve_chips_per_replica``),
  * dry-run knobs (microbatch, remat, optimizer choice for giant models).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

# ----------------------------------------------------------------- layer IR

# Layer kinds inside a period block.
ATTN = "attn"              # global self-attention
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
ATTN_CROSS = "attn_cross"  # cross-attention to frontend embeddings (vlm/audio)
MAMBA = "mamba"            # Mamba2 SSD block
# MLP kinds.
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the period block: (mixer kind, mlp kind).

    ``cross=True`` adds a cross-attention sublayer after the mixer
    (whisper-style decoder layers); ``mixer=ATTN_CROSS`` *replaces* the
    self-attention with cross-attention (llama-3.2-vision image layers).
    """

    mixer: str
    mlp: str = DENSE
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"
    skip: Optional[str] = None  # reason string when the cell is skipped


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    source: str               # provenance tag from the assignment
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # Attention flavour.
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    final_softcap: Optional[float] = None    # gemma2: 30.0
    sliding_window: Optional[int] = None     # gemma2 local layers: 4096
    local_global: bool = False               # alternate local/global layers
    rope_theta: float = 10000.0
    # MoE.
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1        # a layer uses MoE iff (idx % moe_period == moe_offset)
    moe_offset: int = 0
    # SSM / hybrid.
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_period: int = 0       # hybrid: 1 attention layer per `attn_period`
    attn_offset: int = 0
    # Cross-attention (vlm) / encoder-decoder (audio).
    cross_attn_period: int = 0  # 1 cross-attn layer per period
    encoder_layers: int = 0     # enc-dec: encoder depth (decoder = n_layers)
    frontend_len: int = 1500    # stub frontend sequence length (frames/patches)
    frontend_batch_scale: float = 1.0
    # Training knobs for the dry-run (memory fitting).
    optimizer: str = "adamw"   # "adamw" | "adafactor"
    microbatch: Optional[int] = None   # per-step microbatch for grad accum
    remat: bool = True
    # Provisioning demand model (PhoenixCloud layer).
    train_chips: int = 256
    serve_chips_per_replica: int = 1

    # ------------------------------------------------------------ structure

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(1, self.n_heads)

    def layer_pattern(self) -> List[LayerSpec]:
        """The period block replicated ``n_layers / len(pattern)`` times."""
        if self.family == "ssm":
            return [LayerSpec(MAMBA, NONE)]
        if self.family == "hybrid":
            period = self.attn_period
            specs = []
            for i in range(period):
                mixer = ATTN if i % period == self.attn_offset else MAMBA
                mlp = MOE if (self.n_experts and i % self.moe_period
                              == self.moe_offset) else DENSE
                specs.append(LayerSpec(mixer, mlp))
            return specs
        if self.family == "vlm":
            period = self.cross_attn_period
            return [LayerSpec(ATTN_CROSS if i == period - 1 else ATTN, DENSE)
                    for i in range(period)]
        if self.local_global:
            return [LayerSpec(ATTN_LOCAL, self._mlp_kind(0)),
                    LayerSpec(ATTN, self._mlp_kind(1))]
        if self.family == "audio":
            # Enc-dec decoder layer: self-attn + cross-attn + MLP.
            return [LayerSpec(ATTN, DENSE, cross=True)]
        return [LayerSpec(ATTN, self._mlp_kind(0))]

    def _mlp_kind(self, idx: int) -> str:
        if self.n_experts and idx % self.moe_period == self.moe_offset:
            return MOE
        return DENSE

    @property
    def n_periods(self) -> int:
        pattern = self.layer_pattern()
        assert self.n_layers % len(pattern) == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by " \
            f"period {len(pattern)}"
        return self.n_layers // len(pattern)

    # ----------------------------------------------------------- shape grid

    def sub_quadratic(self) -> bool:
        """Eligibility for long_500k (SSM/hybrid only, per assignment)."""
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> Dict[str, ShapeSpec]:
        long_skip = None if self.sub_quadratic() else (
            "long_500k needs sub-quadratic attention; "
            f"{self.name} is full-attention (family={self.family}) — "
            "skip per assignment note in DESIGN.md")
        return {
            "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
            "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
            "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
            "long_500k": ShapeSpec("long_500k", 524288, 1, "decode",
                                   skip=long_skip),
        }

    # ------------------------------------------------------- size accounting

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        dense_mlp = 3 * d * f
        moe_mlp = self.n_experts * 3 * d * f + d * self.n_experts
        d_inner = self.ssm_expand * d
        n_ssm_heads = max(1, d_inner // self.ssm_head_dim)
        mamba = (d * (2 * d_inner + 2 * self.ssm_state + n_ssm_heads)
                 + d_inner * d + self.ssm_conv
                 * (d_inner + 2 * self.ssm_state) + 3 * n_ssm_heads)
        total = v * d                     # embedding (tied head)
        for spec in self.layer_pattern():
            n = self.n_periods
            if spec.mixer in (ATTN, ATTN_LOCAL):
                total += n * attn
            elif spec.mixer == ATTN_CROSS:
                total += n * attn
            elif spec.mixer == MAMBA:
                total += n * mamba
            if spec.mlp == DENSE:
                total += n * dense_mlp
            elif spec.mlp == MOE:
                total += n * moe_mlp
        total += self.encoder_layers * (attn + dense_mlp)
        total += self.n_layers * 2 * d    # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * f
        n_moe_layers = sum(1 for s in self.layer_pattern() if s.mlp == MOE) \
            * self.n_periods
        return self.param_count() - n_moe_layers * inactive


# ------------------------------------------------------------------ registry

ARCH_IDS = [
    "gemma2_2b", "smollm_135m", "qwen2_5_14b", "qwen1_5_0_5b",
    "llama32_vision_90b", "jamba15_large_398b", "whisper_base",
    "granite_moe_3b", "grok1_314b", "mamba2_130m",
]

_ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "smollm-135m": "smollm_135m",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "whisper-base": "whisper_base",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "grok-1-314b": "grok1_314b",
    "mamba2-130m": "mamba2_130m",
}


def get_config(arch: str) -> ArchConfig:
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test-sized config of the same family (small dims, same
    layer pattern structure)."""
    pattern = len(cfg.layer_pattern())
    base = dict(
        n_layers=2 * pattern if cfg.family != "hybrid" else pattern,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=512,
        head_dim=16,
        sliding_window=64 if cfg.sliding_window else None,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_len=32,
        microbatch=None,
        train_chips=1,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
