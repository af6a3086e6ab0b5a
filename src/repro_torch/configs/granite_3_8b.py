"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 vocab49155.
[hf:ibm-granite/granite-3.0-8b-base family; assignment-exact numbers]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv=8, d_ff=12800, vocab=49155, d_head=128,
    rope_theta=10000.0, tied_embeddings=True, remat="full",
)

SMOKE = ArchConfig(
    name="granite-3-8b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=1, d_ff=128, vocab=512, d_head=16,
    rope_theta=10000.0, tied_embeddings=True,
)
