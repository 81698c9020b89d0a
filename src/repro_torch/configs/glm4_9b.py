"""GLM-4-9B dense decoder.  [hf:THUDM/glm-4-9b]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.  RoPE, RMSNorm,
SwiGLU.  (GLM's partial-rotary detail is simplified to full RoPE, as in
the reference.)  A copy of ``repro.configs.glm4_9b``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, d_head=128, rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
)
REDUCED = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, d_head=16, attn_chunk=32,
)
register(CONFIG, REDUCED)
