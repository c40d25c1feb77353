"""smollm-135m [dense] — llama-arch small, GQA 9q/3kv.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm_135m", family="dense", source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, head_dim=64,
    rope_theta=10000.0,
    microbatch=64, train_chips=1, serve_chips_per_replica=1,
)
