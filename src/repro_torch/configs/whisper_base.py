"""whisper-base [audio] — encoder-decoder, conv frontend stubbed: the
encoder consumes precomputed 1500-frame embeddings from input_specs().
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_base", family="audio", source="arXiv:2212.04356; unverified",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, head_dim=64,
    encoder_layers=6, frontend_len=1500,
    microbatch=64, train_chips=1, serve_chips_per_replica=1,
)
