"""Model configurations served by the port: the paper's conv table and the
ten LM architectures (shapes only; weights are random from a seed)."""
from repro_torch.configs import (
    gemma3_12b, gemma2_27b, starcoder2_15b, qwen3_14b, phi3_vision_4b,
    hymba_1_5b, deepseek_v2_lite, mixtral_8x7b, whisper_small, mamba2_2_7b,
)
from repro_torch.configs.paper_convs import TABLE1, BATCH_SIZES, ConvLayer

__all__ = ["TABLE1", "BATCH_SIZES", "ConvLayer", "ARCH_NAMES", "get_config",
           "LONG_CONTEXT_OK"]

_MODULES = {
    "gemma3-12b": gemma3_12b,
    "gemma2-27b": gemma2_27b,
    "starcoder2-15b": starcoder2_15b,
    "qwen3-14b": qwen3_14b,
    "phi-3-vision-4.2b": phi3_vision_4b,
    "hymba-1.5b": hymba_1_5b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "mixtral-8x7b": mixtral_8x7b,
    "whisper-small": whisper_small,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.FULL


# long_500k applicability: run where a sub-quadratic layer majority exists;
# skip for pure full attention / enc-dec.
LONG_CONTEXT_OK = {
    "gemma3-12b": True,        # 5:1 local:global
    "gemma2-27b": True,        # 1:1 local:global
    "starcoder2-15b": False,   # pure full attention
    "qwen3-14b": False,        # pure full attention
    "phi-3-vision-4.2b": False,
    "hymba-1.5b": True,        # SWA + SSM
    "deepseek-v2-lite-16b": False,  # MLA is full attention
    "mixtral-8x7b": True,      # SWA
    "whisper-small": False,    # decoder ctx <= 448 by construction
    "mamba2-2.7b": True,       # SSM
}
