"""Config registry: ``get_config(arch)``, ``SHAPES``, smoke reductions."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, EncoderConfig, MoEConfig,
                                RGLRUConfig, SHAPES, ShapeSpec, SSMConfig,
                                shape_applicable)

from repro_torch.configs import (chatglm3_6b, deepseek_moe_16b, gemma3_4b,
                           internvl2_26b, mamba2_1_3b, mistral_nemo_12b,
                           olmoe_1b_7b, qwen3_0_6b, recurrentgemma_2b,
                           whisper_small)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma3_4b, mistral_nemo_12b, qwen3_0_6b, chatglm3_6b,
              deepseek_moe_16b, olmoe_1b_7b, mamba2_1_3b,
              recurrentgemma_2b, internvl2_26b, whisper_small)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab; structure (pattern, GQA ratio, MoE topology,
    qk_norm, rope mode) preserved."""
    pat = tuple(cfg.block_pattern)
    n_layers = len(pat) + min(2, len(pat))  # ≥1 full pattern + remainder
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, (cfg.n_heads // max(1, cfg.n_kv_heads)) * kv)
    changes: dict = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab=512,
        window=32,
        max_position=4096,
        param_dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.num_shared else 0,
            d_ff_dense=256 if cfg.moe.first_k_dense else 0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk=8)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, lru_width=128)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(
            cfg.encoder,
            n_layers=2 if cfg.encoder.n_layers else 0,
            n_frames=24, n_patches=16,
            frontend_dim=48 if cfg.encoder.frontend_dim else 0)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCHS", "ArchConfig", "EncoderConfig", "MoEConfig",
           "RGLRUConfig", "SHAPES", "SSMConfig", "ShapeSpec", "get_config",
           "list_archs", "shape_applicable", "smoke_config"]
