"""llama3.2-3b [dense]: 28L d3072 24H (GQA kv=8) ff8192 vocab128256.
[hf:meta-llama/Llama-3.2-3B family]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv=8, d_ff=8192, vocab=128256, d_head=128,
    rope_theta=500000.0, tied_embeddings=True, remat="full",
)

SMOKE = ArchConfig(
    name="llama3.2-3b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv=2, d_ff=192, vocab=512, d_head=16,
    rope_theta=500000.0, tied_embeddings=True,
)
