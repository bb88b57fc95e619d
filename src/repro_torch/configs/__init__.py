"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``; port of
``repro/configs/__init__.py``, all ten configs as pure data."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES

_REGISTRY: dict[str, str] = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_v2",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large",
    # the paper's own benchmark "config" (DBSCAN problem, not an LM)
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch]).CONFIG


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """Assignment rules: decode shapes need a decoder; long_500k needs
    sub-quadratic attention (ssm/hybrid only)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.has_decoder:
        out.append(SHAPES["decode_32k"])
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "shapes_for"]
