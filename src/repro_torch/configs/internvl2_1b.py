"""InternVL2-1B: InternViT frontend (stub) + Qwen2-0.5B language backbone.
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The ViT is a stub:
``input_specs`` supplies 256 precomputed patch embeddings per sequence
(``embeds`` of ``prefill`` and ``forward`` in the port).  A copy of
``repro.configs.internvl2_1b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, d_head=64, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    frontend="vision_patches", n_prefix=256,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
)
REDUCED = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, d_head=16, qkv_bias=True, tie_embeddings=True,
    frontend="vision_patches", n_prefix=4, attn_chunk=32,
)
register(CONFIG, REDUCED)
