"""Model configuration system + architecture registry.

Ports ``repro.configs.base``: the same frozen ``ModelConfig``, field for
field, so a configuration reads the same in both packages, with its helpers
(``is_attention_free``, ``is_subquadratic``, ``supports_shape``,
``param_count``, ``active_param_count``), the global shape set ``SHAPES``,
the registry, ``get_config``, ``list_configs``, ``reduced`` and the mesh
padding (``pad_for_mesh`` and the padded sizes ``heads_p``, ``kv_heads_p``,
``vocab_p`` and ``experts_p``).  Every registered architecture has an exact
published ``ModelConfig`` plus a ``reduced()`` variant for CPU tests.

Every configuration the reference registers is loaded (``_ensure_loaded``):
the dense ``qwen2-0.5b``, ``qwen2.5-3b``, ``qwen2.5-14b`` and ``glm4-9b``,
the frontend ``internvl2-1b`` and ``musicgen-medium``, the SSM
``mamba2-130m``, the hybrid ``recurrentgemma-2b`` and the MoE
``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_configs", "reduced", "pad_for_mesh"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


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
    # training memory (models.transformer._remat): "none" keeps every
    # activation, "dots" keeps the products with no batch dimension and
    # recomputes the rest of each layer group, any other value ("full")
    # recomputes each group whole in the backward; the bits are the same
    remat: str = "full"                # full | dots | none
    scan_layers: bool = True           # (read by the JAX package)
    attn_chunk: int = 1024             # KV-chunk for memory-bounded attention
    loss_chunk: int = 0                # 0 = unchunked vocab loss
    # --- mesh padding (set by pad_for_mesh; 0 = unpadded) -------------------
    # dims sharded over a model axis must divide it, so they are padded in
    # the PARAMETERS and masked inert at run time (zero forward
    # contribution, zero gradients); the logical architecture's counts
    # (param_count, active_param_count) are the unpadded ones
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    vocab_padded: int = 0
    n_experts_padded: int = 0
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def heads_p(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def kv_heads_p(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def vocab_p(self) -> int:
        return self.vocab_padded or self.vocab_size

    @property
    def experts_p(self) -> int:
        return self.n_experts_padded or self.n_experts

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

    @property
    def is_attention_free(self) -> bool:
        kinds = set(self.block_pattern) | set(self.tail_pattern)
        return not kinds & {"attn", "local_attn", "moe"}

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch never attends over the full sequence ("moe"
        blocks carry full GQA attention)."""
        kinds = set(self.block_pattern) | set(self.tail_pattern)
        return not kinds & {"attn", "moe"}

    def supports_shape(self, shape: ShapeSpec) -> tuple[bool, str]:
        if shape.name == "long_500k" and not self.is_subquadratic:
            return False, "full-attention arch: 500k decode skipped per assignment"
        return True, ""

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

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.param_count()
        dense_like = replace(self, n_experts=self.experts_per_token)
        return dense_like.param_count()


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


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def pad_for_mesh(cfg: ModelConfig, tp: int, pad_kv: bool = False) -> ModelConfig:
    """Pad the dims sharded over a model axis of ``tp`` up to multiples of it:
    query heads, vocab and experts; KV heads with the heads where they equal
    them (MHA), or under ``pad_kv`` (the decode KV-shard policy).

    Under ``pad_kv`` the heads pad to kvp x G with the ORIGINAL group size
    G, so real query head h keeps its index and its KV head h // G, and the
    padded KV heads serve only padded query heads.  Otherwise a GQA
    config's padded heads regroup onto the same KV heads: G becomes
    ``heads_p // n_kv_heads``, and real head h then reads KV head
    h // G_padded, as in the reference.  Padded slots are inert (masked in
    the attention output, the router and the logits), at the cost of idle
    work on the padded share.  Raises ``ValueError`` where the padded heads
    do not divide over the KV heads.
    """
    def up(n: int, m: int) -> int:
        return -(-n // m) * m

    hp = up(cfg.n_heads, tp) if cfg.n_heads % tp else cfg.n_heads
    kvp = cfg.n_kv_heads
    if cfg.n_kv_heads == cfg.n_heads:          # MHA: pad KV with the heads
        kvp = hp
    elif pad_kv and cfg.n_kv_heads % tp:
        kvp = up(cfg.n_kv_heads, tp)
        hp = kvp * (cfg.n_heads // cfg.n_kv_heads)
    elif hp % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: padded heads {hp} not divisible by "
                         f"kv heads {cfg.n_kv_heads}")
    vp = up(cfg.vocab_size, tp) if cfg.vocab_size % tp else cfg.vocab_size
    ep = up(cfg.n_experts, tp) if cfg.n_experts and cfg.n_experts % tp else cfg.n_experts
    return replace(cfg, n_heads_padded=hp, n_kv_heads_padded=kvp,
                   vocab_padded=vp, n_experts_padded=ep)


def _ensure_loaded() -> None:
    # always import (a cached import is a dict lookup): a registry that is
    # merely non-empty may hold only a config module imported on its own
    from repro_torch.configs import (glm4_9b, granite_moe_3b_a800m,  # noqa: F401
                                     internvl2_1b, mamba2_130m, musicgen_medium,
                                     qwen2_0_5b, qwen2_5_14b, qwen2_5_3b,
                                     qwen3_moe_235b_a22b, recurrentgemma_2b)
