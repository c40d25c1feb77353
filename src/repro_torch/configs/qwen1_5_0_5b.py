"""qwen1.5-0.5b [dense] — QKV bias, kv=16 (MHA). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_0_5b", family="dense", source="hf:Qwen/Qwen1.5-0.5B; hf",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, head_dim=64, qkv_bias=True,
    rope_theta=10000.0,
    microbatch=64, train_chips=2, serve_chips_per_replica=1,
)
