"""Model configuration system + architecture registry.

Ports ``repro.configs.base``: the same frozen ``ModelConfig`` (field for
field but for the mesh-padding ones, so a configuration reads the same in
both packages), the registry, ``get_config`` and ``reduced``.  Every
registered architecture has an exact published ``ModelConfig`` plus a
``reduced()`` variant for CPU tests.

Only the configurations the port can run are loaded (``_ensure_loaded``):
``qwen2-0.5b`` so far.  The mesh-padding fields and ``pad_for_mesh`` come
with the multi-device slice, and the reference's shape set and its helpers
with the code that reads them.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ModelConfig", "register", "get_config", "reduced"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    norm_type: str = "rms"             # rms | layer
    mlp_type: str = "swiglu"           # swiglu | geglu | gelu
    pos_emb: str = "rope"              # rope | sinusoidal | none
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048     # GShard-style dispatch group
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: tuple = ("attn",)   # layer kinds of one repeated group
    tail_pattern: tuple = ()           # remainder layers
    local_window: int = 0              # local attention window (0 = full)
    lru_width: int = 0                 # RG-LRU recurrence width (0 = d_model)
    logits_soft_cap: float = 0.0
    # --- modality frontend stub ---
    frontend: str | None = None        # None | "audio_frames" | "vision_patches"
    n_prefix: int = 0                  # frontend embedding positions
    # --- numerics / runtime ---
    dtype: str = "bfloat16"
    remat: str = "full"                # full | dots | none (read by the JAX package)
    scan_layers: bool = True           # (read by the JAX package)
    attn_chunk: int = 1024             # KV-chunk for memory-bounded attention
    loss_chunk: int = 0                # 0 = unchunked vocab loss
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_groups(self) -> int:
        """Number of repeated groups of ``block_pattern``."""
        body = self.n_layers - len(self.tail_pattern)
        assert body % len(self.block_pattern) == 0, (
            f"{self.name}: {body} layers not divisible by pattern "
            f"{self.block_pattern}")
        return body // len(self.block_pattern)

    @property
    def layer_kinds(self) -> tuple:
        """Every layer's block kind, in layer order."""
        return tuple(self.block_pattern) * self.n_groups + tuple(self.tail_pattern)

    # -- parameter counting --------------------------------------------------
    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        n_attn = self.d_model * dh * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * dh * d
        if self.qkv_bias:
            n_attn += dh * (self.n_heads + 2 * self.n_kv_heads)
        n_mlp_dense = 3 * d * self.d_ff          # SwiGLU
        n_moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        d_inner = self.ssm_expand * d
        n_heads_ssm = d_inner // self.ssm_head_dim if self.ssm_head_dim else 0
        n_ssm = (d * (2 * d_inner + 2 * self.ssm_state + n_heads_ssm)
                 + self.ssm_conv * (d_inner + 2 * self.ssm_state)
                 + 2 * n_heads_ssm + d_inner * d)
        w = self.lru_width or d
        n_rglru = (d * 2 * w) + 4 * w * 2 + 2 * w + w * d  # proj + conv4 + gates + out
        per_kind = {"attn": n_attn + n_mlp_dense,
                    "local_attn": n_attn + n_mlp_dense,
                    "moe": n_attn + n_moe,
                    "ssm": n_ssm,
                    "rglru": n_rglru + n_mlp_dense}
        total = sum(per_kind[k] for k in self.layer_kinds)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += d * (2 * self.n_layers + 1)     # norms
        return int(total)

_REGISTRY: dict[str, "ModelConfig"] = {}
_REDUCED: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig, reduced_cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced_cfg
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return table[name]


def reduced(name: str) -> ModelConfig:
    return get_config(name, reduced=True)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import qwen2_0_5b  # noqa: F401
