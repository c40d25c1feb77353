"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_3b", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    n_experts=40, experts_per_token=8,
    microbatch=32, train_chips=8, serve_chips_per_replica=1,
)
