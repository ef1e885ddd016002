"""Architecture configs of the port (copies of ``repro.configs``), one
module per architecture (``--arch <id>``)."""
from .base import SHAPES, ArchConfig, ShapeSpec, valid_cells

ARCHS = {
    "rwkv6-1.6b": "rwkv6_1b6",
    "qwen1.5-32b": "qwen15_32b",
    "phi3-mini-3.8b": "phi3_mini",
    "qwen1.5-110b": "qwen15_110b",
    "granite-3-2b": "granite3_2b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2b7",
    "internvl2-76b": "internvl2_76b",
    "mixtral-8x7b": "mixtral_8x7b",
    "arctic-480b": "arctic_480b",
}


def get_config(arch: str) -> ArchConfig:
    import importlib

    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config", "valid_cells"]
