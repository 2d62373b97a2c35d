"""Layers around the planned convolutions."""
from __future__ import annotations

import torch.nn.functional as TF


def maxpool2x2(x):
    """2x2/stride-2 max pool over the spatial axes of NCHW ``x``."""
    return TF.max_pool2d(x, 2, 2)
