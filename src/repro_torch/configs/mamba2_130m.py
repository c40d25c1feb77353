"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_130m", family="ssm", source="arXiv:2405.21060; unverified",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    microbatch=64, train_chips=1, serve_chips_per_replica=1,
)
