"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
GQA 8q/4kv. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2_2b", family="dense", source="arXiv:2408.00118; hf",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256,
    attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global=True,
    rope_theta=10000.0,
    microbatch=32, train_chips=16, serve_chips_per_replica=1,
)
