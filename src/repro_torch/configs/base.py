"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig`` in its own module under
``repro_torch.configs`` (a copy of the JAX package's ``repro.configs``);
the four input-shape cells are ``ShapeSpec``s. The registry resolves
``--arch`` / ``--shape`` strings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek-moe)
    d_ff_dense: int = 0             # their FFN width
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 → d_model
    conv_width: int = 4
    c_constant: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) / frontend stubs (vlm)."""
    n_layers: int = 0
    n_frames: int = 1500            # whisper: mel frames after conv stub
    n_patches: int = 1024           # vlm: vision patches after ViT stub
    frontend_dim: int = 0           # stub embedding dim (0 → d_model)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention structure
    block_pattern: Sequence[str] = ("global",)   # per-layer kinds, repeated
    window: int = 1024                            # sliding-window size
    rope_theta: float = 10000.0
    rope_mode: str = "full"         # full | half (chatglm 2d) | none
    qk_norm: bool = False
    logits_softcap: float = 0.0
    # substructure configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    # numerics
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # capability flags (shape applicability, DESIGN §4)
    sub_quadratic: bool = False     # can run long_500k
    enc_dec: bool = False
    max_position: int = 1 << 20

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def pattern_layers(self) -> tuple[int, int, Sequence[str]]:
        """(full_repeats, remainder, pattern) covering n_layers."""
        p = len(self.block_pattern)
        return self.n_layers // p, self.n_layers % p, self.block_pattern

    def param_count(self) -> int:
        """Total parameters N (embedding included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn_o = self.n_heads * self.head_dim * d
        per_layer = 0
        counts = {"attn": 0, "ffn": 0, "ssm": 0, "rglru": 0}
        reps, rem, pattern = self.pattern_layers()
        kinds = list(pattern) * reps + list(pattern[:rem])
        total = 0
        for li, kind in enumerate(kinds):
            total += 2 * d  # norms
            if kind in ("global", "local"):
                total += qkv + attn_o
                total += self._ffn_params(li)
            elif kind == "rglru":
                w = (self.rglru.lru_width or d) if self.rglru else d
                total += 2 * d * w + 2 * w + w * (self.rglru.conv_width
                                                  if self.rglru else 4)
                total += w * d
                total += self._ffn_params(li)
            elif kind == "ssm":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                total += d * (2 * d_in + 2 * nheads * s.state_dim + nheads)
                total += d_in * s.conv_width + d_in * d + 2 * nheads
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        del per_layer, counts
        return total

    def _ffn_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is None:
            return 3 * d * self.d_ff  # SwiGLU
        m = self.moe
        if layer_idx < m.first_k_dense:
            return 3 * d * m.d_ff_dense
        total = m.num_experts * 3 * d * m.d_ff_expert
        total += m.num_shared * 3 * d * m.d_ff_shared
        total += d * m.num_experts  # router
        return total

    def active_param_count(self) -> int:
        """N_active for MoE (6·N_active·D MODEL_FLOPS convention)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_total = self.param_count()
        routed_all = (self.n_layers - m.first_k_dense) * \
            m.num_experts * 3 * self.d_model * m.d_ff_expert
        routed_active = (self.n_layers - m.first_k_dense) * \
            m.top_k * 3 * self.d_model * m.d_ff_expert
        return dense_total - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    needs_sub_quadratic: bool = False


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode",
                           needs_sub_quadratic=True),
}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """DESIGN §4 applicability matrix."""
    if shape.needs_sub_quadratic and not arch.sub_quadratic:
        return False, ("pure full-attention arch — 500k decode KV cache is "
                       "quadratic-history; skipped per DESIGN §4")
    if arch.enc_dec and shape.needs_sub_quadratic:
        return False, "enc-dec decoder is short-context by construction"
    return True, ""
