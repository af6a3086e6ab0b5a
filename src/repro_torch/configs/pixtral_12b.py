"""pixtral-12b [vlm]: 40L d5120 32H (GQA kv=8) ff14336 vocab131072 -
mistral-nemo backbone; pixtral-ViT frontend is a stub (input_specs()
provides precomputed patch embeddings). [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, d_ff=14336, vocab=131072, d_head=128,
    n_patches=256, rope_theta=1000000.0, tied_embeddings=False,
    remat="full",
)

SMOKE = ArchConfig(
    name="pixtral-12b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv=1, d_ff=128, vocab=512, d_head=16,
    n_patches=8, rope_theta=1000000.0, tied_embeddings=False,
)
