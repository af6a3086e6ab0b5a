"""whisper-large-v3 [audio]: enc-dec, 32+32L d1280 20H ff5120 vocab51866.
[arXiv:2212.04356] Conv/mel frontend is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, d_model)."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec", n_layers=32, d_model=1280,
    n_heads=20, n_kv=20, d_ff=5120, vocab=51866, d_head=64,
    n_enc_layers=32, src_len=1500, norm="ln", mlp="gelu",
    tied_embeddings=True, remat="full",
)

SMOKE = ArchConfig(
    name="whisper-large-v3-smoke", family="encdec", n_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512, d_head=16,
    n_enc_layers=2, src_len=64, norm="ln", mlp="gelu",
    tied_embeddings=True,
)
