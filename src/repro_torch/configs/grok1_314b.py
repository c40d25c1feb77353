"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok1_314b", family="moe", source="hf:xai-org/grok-1; unverified",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128,
    n_experts=8, experts_per_token=2,
    optimizer="adafactor", microbatch=32,
    train_chips=256, serve_chips_per_replica=64,
)
