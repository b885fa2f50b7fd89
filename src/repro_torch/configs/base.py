"""Architecture config system.

Copy of ``repro.configs.base``: the layer kinds, ``MoEConfig``,
``MambaConfig`` and ``ArchConfig`` with ``smoke()``, and the registry.
Only the architectures whose layers the port runs are registered
(``phi3-mini-3.8b``, ``mamba2-1.3b``); any other name raises
``KeyError``.  The shape cells of the TPU dry-run are not part of this
package.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Layer kinds composing a repeating pattern group.
# ---------------------------------------------------------------------------
ATTN = "attn"            # full causal attention
ATTN_SWA = "attn_swa"    # sliding-window causal attention
MAMBA = "mamba"          # mamba2 SSD block
ENC_ATTN = "enc_attn"    # bidirectional (encoder) attention


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0          # deepseek-style always-on experts
    expert_d_ff: Optional[int] = None    # if != d_ff (fine-grained experts)
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    @property
    def d_ff_expert(self) -> int:
        return self.expert_d_ff if self.expert_d_ff is not None else 0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                     # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    # Repeating layer pattern; length must divide num_layers. None => [ATTN].
    pattern: Optional[Sequence[str]] = None
    # Which pattern positions carry an MoE FFN instead of a dense MLP.
    moe_positions: Optional[Sequence[int]] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # attention details
    sliding_window: Optional[int] = None  # window for ATTN_SWA layers
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0            # partial rotary (stablelm)
    qk_norm: bool = False                 # gemma3
    attn_logit_softcap: Optional[float] = None
    # block details
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    parallel_block: bool = False          # command-r: attn & mlp in parallel
    use_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                     # silu (swiglu) | gelu (plain mlp)
    glu: bool = True                      # gated MLP (SwiGLU) vs plain 2-layer
    # encoder-decoder (whisper)
    enc_dec: bool = False
    num_encoder_layers: int = 0
    # modality frontend stub (vlm/audio)
    embed_frontend: Optional[str] = None  # None | "patch" | "frame"
    sub_quadratic: bool = False
    notes: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def resolved_pattern(self) -> Sequence[str]:
        return tuple(self.pattern) if self.pattern else (ATTN,)

    @property
    def n_groups(self) -> int:
        p = len(self.resolved_pattern)
        if self.num_layers % p:
            raise ValueError(f"{self.name}: {self.num_layers} layers do not "
                             f"divide into pattern groups of {p}")
        return self.num_layers // p

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        p = self.resolved_pattern
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 2
        moe = None
        moe_pos = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=64 if self.moe.expert_d_ff is not None else None,
            )
            moe_pos = self.moe_positions
        mamba = replace(self.mamba, d_state=16, head_dim=16, chunk=32) if self.mamba else None
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 * len(p),
            num_encoder_layers=2 if self.enc_dec else 0,
            d_model=64,
            num_heads=4,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else None,
            moe=moe,
            moe_positions=moe_pos,
            mamba=mamba,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"arch {cfg.name!r} registered twice")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _populate() -> None:
    import repro_torch.configs.mamba2_1_3b  # noqa: F401  (registers)
    import repro_torch.configs.phi3_mini_3_8b  # noqa: F401


def get_config(name: str) -> ArchConfig:
    """The config registered as ``name``; ``<name>-smoke`` is its
    reduced CPU-test form.  Architectures the port does not run yet
    raise ``KeyError``."""
    _populate()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet (ported: "
                       f"{', '.join(sorted(_REGISTRY))})") from None

