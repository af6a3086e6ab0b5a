"""deepseek-v2-236b [moe]: 60L d5120 128H ff(expert)=1536 vocab102400,
MLA kv_lora=512, 2 shared + 160 routed top-6. [arXiv:2405.04434]

Assignment-exact: all 60 layers MoE (the HF release uses
first_k_dense_replace=1 with dense ff 12288 - we follow the assignment's
uniform spec; toggle first_k_dense/dense_ff to restore the HF layout).
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="mla_moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv=128, d_ff=1536, vocab=102400,
    n_routed=160, n_shared=2, top_k=6, d_expert=1536,
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
    rope_theta=10000.0, tied_embeddings=False, remat="full",
)

SMOKE = ArchConfig(
    name="deepseek-v2-236b-smoke", family="mla_moe", n_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_ff=32, vocab=512,
    n_routed=8, n_shared=1, top_k=2, d_expert=32,
    q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
    rope_theta=10000.0, tied_embeddings=False,
)
