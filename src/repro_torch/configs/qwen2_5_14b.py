"""Qwen2.5-14B dense decoder.  [hf:Qwen/Qwen2.5-14B]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.  A copy of
``repro.configs.qwen2_5_14b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, d_head=128, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-14B (family card hf:Qwen/Qwen2.5-0.5B)",
)
REDUCED = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=192,
    vocab_size=128, d_head=16, qkv_bias=True, attn_chunk=32,
)
register(CONFIG, REDUCED)
