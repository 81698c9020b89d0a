"""Mamba2-130M (SSD, attention-free).  [arXiv:2405.21060]

24L d_model=768, ssm_state=128, expand=2, head_dim=64, vocab=50280, tied
embeddings.  A copy of ``repro.configs.mamba2_130m``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, d_ff=0,
    vocab_size=50280, d_head=64, tie_embeddings=True, pos_emb="none",
    block_pattern=("ssm",),
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-130m",
)
REDUCED = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=128, d_head=16, tie_embeddings=True, pos_emb="none",
    block_pattern=("ssm",),
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
)
register(CONFIG, REDUCED)
