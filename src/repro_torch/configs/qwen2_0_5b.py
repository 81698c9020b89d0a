"""Qwen2-0.5B dense decoder.  [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, QKV bias, tied
embeddings.  A copy of ``repro.configs.qwen2_0_5b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, d_head=64, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)
REDUCED = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, d_head=16, qkv_bias=True, tie_embeddings=True, attn_chunk=32,
)
register(CONFIG, REDUCED)
