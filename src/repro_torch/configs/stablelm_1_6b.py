"""stablelm-1.6b [dense]: 24L d2048 32H (kv=32, MHA) ff5632 vocab100352.
[hf:stabilityai/stablelm-2-1_6b; assignment-exact. Simplification:
full RoPE instead of stablelm's 25% partial rotary, as in the JAX package.]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv=32, d_ff=5632, vocab=100352, d_head=64,
    rope_theta=10000.0, tied_embeddings=False, remat="full",
)

SMOKE = ArchConfig(
    name="stablelm-1.6b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=4, d_ff=128, vocab=512, d_head=16,
    rope_theta=10000.0, tied_embeddings=False,
)
