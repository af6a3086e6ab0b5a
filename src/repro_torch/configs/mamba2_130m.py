"""mamba2-130m [ssm]: 24L d768 (attention-free) ssm_state=128
vocab50280 - SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    d_state=128, expand=2, ssm_head_dim=64, n_groups=1,
    tied_embeddings=True, remat="full",
)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv=0, d_ff=0, vocab=512,
    d_state=16, expand=2, ssm_head_dim=16, n_groups=1,
    tied_embeddings=True,
)
