"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer;
patch-embedding frontend is a stub (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama32_vision_90b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128,
    cross_attn_period=5, frontend_len=1601,   # (560/14)^2 + 1 patches
    rope_theta=500000.0,
    optimizer="adafactor", microbatch=8,
    train_chips=256, serve_chips_per_replica=32,
)
