"""deepseek-moe-16b [moe]: 28L d2048 16H (kv=16) ff(expert)=1408
vocab102400, 2 shared + 64 routed top-6, fine-grained. [arXiv:2401.06066]
Assignment-exact: all layers MoE (HF uses first_k_dense_replace=1)."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=102400, d_head=128,
    n_routed=64, n_shared=2, top_k=6, d_expert=1408,
    rope_theta=10000.0, tied_embeddings=False, remat="full",
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=4, d_ff=32, vocab=512, d_head=16,
    n_routed=8, n_shared=1, top_k=2, d_expert=32,
    rope_theta=10000.0, tied_embeddings=False,
)
