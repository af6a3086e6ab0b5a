"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) ff16384 vocab92544.
[arXiv:2403.17297]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=92544, d_head=128,
    rope_theta=1000000.0, tied_embeddings=False, remat="full",
)

SMOKE = ArchConfig(
    name="internlm2-20b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv=1, d_ff=192, vocab=512, d_head=16,
    rope_theta=1000000.0, tied_embeddings=False,
)
