"""Granite-3.0-3B-A800M MoE.  [hf:ibm-granite/granite-3.0-3b-a800m-base
(family card hf:ibm-granite/granite-3.0-1b-a400m-base)]

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
40 experts top-8, tied embeddings.  A copy of
``repro.configs.granite_moe_3b_a800m``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, d_head=64, tie_embeddings=True,
    block_pattern=("moe",),
    n_experts=40, experts_per_token=8, capacity_factor=1.25,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)
REDUCED = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=128, d_head=16, tie_embeddings=True,
    block_pattern=("moe",),
    n_experts=8, experts_per_token=2, capacity_factor=8.0, attn_chunk=32,
)
register(CONFIG, REDUCED)
