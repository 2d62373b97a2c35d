"""One train step of the first five LM architectures (small form,
float32) against the JAX package's: the twin of
``tests/test_models.py::test_train_step_no_nan``, held to the reference's
numbers (``torch_lm_train.check_step``)."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.configs import ARCH_NAMES  # noqa: E402

import torch_lm_train as T  # noqa: E402
from torch_lm_train import one_torch_thread  # noqa: E402,F401

ARCHS = ARCH_NAMES[:5]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    T.check_step(T.run(arch))
