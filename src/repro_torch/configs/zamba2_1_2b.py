"""zamba2-1.2b [hybrid]: 38L d2048 32H (kv=32) ff8192 ssm_state=64 -
Mamba2 backbone + one shared attention block applied every 6 layers.
[arXiv:2411.15242] Per-site LoRA deltas omitted, as in the JAX package."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    d_state=64, expand=2, ssm_head_dim=64, n_groups=1, attn_every=6,
    rope_theta=10000.0, tied_embeddings=True, remat="full",
)

SMOKE = ArchConfig(
    name="zamba2-1.2b-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv=4, d_ff=128, vocab=512,
    d_state=16, expand=2, ssm_head_dim=16, n_groups=1, attn_every=2,
    rope_theta=10000.0, tied_embeddings=True,
)
