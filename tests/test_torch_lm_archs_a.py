"""The port's LM slice against the JAX package for half of the ten
architectures (the checks are in ``torch_lm_archs.py``): forward (whisper:
encode), prefill, three greedy decode steps, the cache after them and the
greedy tokens, each within 1e-4 of the reference's largest |value| in
float32, the tokens equal."""
import pytest

import torch_lm_archs as A

ARCHS = ["gemma3-12b", "gemma2-27b", "starcoder2-15b", "qwen3-14b",
         "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("check", ["forward", "prefill", "decode", "cache",
                                   "greedy_tokens"])
def test_slice_matches_the_jax_package(arch, check):
    getattr(A, f"check_{check}")(arch)
