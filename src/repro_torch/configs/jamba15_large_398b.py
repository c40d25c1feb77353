"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. Mamba layers use Mamba2/SSD blocks (the
assignment pairs this arch with the SSD formulation; deviation from
Jamba's Mamba1 documented in DESIGN.md). [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba15_large_398b", family="hybrid",
    source="arXiv:2403.19887; hf",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_period=2, moe_offset=1,
    attn_period=8, attn_offset=3,          # 1 attention layer per 8 (1:7)
    ssm_state=128, ssm_expand=2, ssm_head_dim=128,
    optimizer="adafactor", microbatch=8,
    train_chips=256, serve_chips_per_replica=64,
)
