"""Qwen3-235B-A22B MoE.  [hf:Qwen/Qwen3-235B-A22B (family card hf:Qwen/Qwen3-30B-A3B)]

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
128 experts top-8.  Every layer is MoE.  A copy of
``repro.configs.qwen3_moe_235b_a22b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, d_head=128, rope_theta=1e6,
    block_pattern=("moe",),
    n_experts=128, experts_per_token=8, capacity_factor=1.25,
    source="hf:Qwen/Qwen3-235B-A22B; family card hf:Qwen/Qwen3-30B-A3B",
)
REDUCED = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=128, d_head=16,
    block_pattern=("moe",),
    n_experts=8, experts_per_token=2, capacity_factor=8.0, attn_chunk=32,
)
register(CONFIG, REDUCED)
