"""qwen2.5-14b [dense] — GQA 40q/8kv, QKV bias. [hf:Qwen/Qwen2.5; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_5_14b", family="dense", source="hf:Qwen/Qwen2.5-0.5B; hf",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1000000.0,
    microbatch=16, train_chips=64, serve_chips_per_replica=4,
)
