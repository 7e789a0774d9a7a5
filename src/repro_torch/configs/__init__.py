"""Config registry. Importing this package registers all architectures."""
from repro_torch.configs import archs  # noqa: F401  (registration side effects)
from repro_torch.configs.base import ModelConfig, RunConfig, get_config, list_configs

ASSIGNED_ARCHS = (
    "granite-moe-3b-a800m",
    "kimi-k2-1t-a32b",
    "internlm2-1.8b",
    "qwen2-72b",
    "h2o-danube-3-4b",
    "qwen3-32b",
    "recurrentgemma-9b",
    "llama-3.2-vision-11b",
    "musicgen-medium",
    "mamba2-370m",
)

# (shape name, seq_len, global_batch, mode)
SHAPES = (
    ("train_4k", 4096, 256, "train"),
    ("prefill_32k", 32768, 32, "prefill"),
    ("decode_32k", 32768, 128, "decode"),
    ("long_500k", 524288, 1, "decode"),
)

__all__ = [
    "ModelConfig",
    "RunConfig",
    "get_config",
    "list_configs",
    "ASSIGNED_ARCHS",
    "SHAPES",
]
