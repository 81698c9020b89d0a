"""MusicGen-Medium decoder backbone over EnCodec tokens.  [arXiv:2306.05284; hf]

48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048.  LayerNorm + GELU
MLP + sinusoidal positions (the MusicGen transformer).  The EnCodec frontend
is a stub: ``input_specs`` supplies precomputed frame embeddings for the
first ``n_prefix`` positions (conditioning prompt; ``embeds`` of
``prefill`` and ``forward`` in the port).  A copy of
``repro.configs.musicgen_medium``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, d_head=64,
    norm_type="layer", mlp_type="gelu", pos_emb="sinusoidal",
    frontend="audio_frames", n_prefix=256,
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)
REDUCED = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=128, d_head=16,
    norm_type="layer", mlp_type="gelu", pos_emb="sinusoidal",
    frontend="audio_frames", n_prefix=4, attn_chunk=32,
)
register(CONFIG, REDUCED)
