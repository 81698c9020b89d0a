"""Qwen2.5-3B dense decoder.  [hf:Qwen/Qwen2.5-3B]

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias, tied
embeddings, RoPE theta 1e6.  A copy of ``repro.configs.qwen2_5_3b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, d_head=128, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-3B (family card hf:Qwen/Qwen2.5-0.5B)",
)
REDUCED = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, d_head=16, qkv_bias=True, tie_embeddings=True, attn_chunk=32,
)
register(CONFIG, REDUCED)
