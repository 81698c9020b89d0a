"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 1:2.  [arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
Pattern (rec, rec, attn) x 8 + (rec, rec) tail = 26 layers; GeGLU MLP.
Sub-quadratic (local attention only).  A copy of
``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, d_head=256, tie_embeddings=True,
    mlp_type="geglu",
    block_pattern=("rglru", "rglru", "local_attn"), tail_pattern=("rglru", "rglru"),
    local_window=2048, lru_width=2560,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)
REDUCED = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_ff=192,
    vocab_size=128, d_head=16, tie_embeddings=True,
    mlp_type="geglu",
    block_pattern=("rglru", "rglru", "local_attn"), tail_pattern=("rglru", "rglru"),
    local_window=16, lru_width=64, attn_chunk=32,
)
register(CONFIG, REDUCED)
