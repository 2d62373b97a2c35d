"""The plain reference of ResNet-50 v1.5 inference: ``torch`` alone.

He et al., arXiv:1512.03385, Table 1, the 50-layer column, with the stride
of each downsampling bottleneck on its 3x3 conv (v1.5, as torchvision's
``resnet50`` has it).  ``F.conv2d`` with its strides, eval-mode
``F.batch_norm`` on the unfolded parameters (torchvision's names), ReLU,
``F.max_pool2d(3, 2, 1)``, the global average pool and ``F.linear``, in
float32 with both TF32 switches off while it runs.

It imports nothing of the port: the port's ResNet (``models/resnet.py``,
batch norm folded into planned convs) is held against it.  Where it
departs from the published model: the weights are whatever it is handed
(the tests' are random, not trained), and the widths are read from them,
so the tests' narrow form runs through the same code.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BLOCKS = (3, 4, 6, 3)          # bottlenecks a stage
STRIDES = (1, 2, 2, 2)         # of each stage's first bottleneck
BN_EPS = 1e-5


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward(params: dict, x: torch.Tensor, *, eps: float = BN_EPS):
    """Logits of the images ``x`` (B, 3, H, W) under the unfolded
    ``params`` (torchvision's state-dict names)."""
    p = params

    def bn(y, name):
        return F.batch_norm(y, p[f"{name}.running_mean"],
                            p[f"{name}.running_var"], p[f"{name}.weight"],
                            p[f"{name}.bias"], training=False, eps=eps)

    with _no_tf32(), torch.no_grad():
        x = F.relu(bn(F.conv2d(x, p["conv1.weight"], stride=2, padding=3),
                      "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for i, (n, stride) in enumerate(zip(BLOCKS, STRIDES), start=1):
            for j in range(n):
                b = f"layer{i}.{j}"
                s = stride if j == 0 else 1
                y = F.relu(bn(F.conv2d(x, p[f"{b}.conv1.weight"]),
                              f"{b}.bn1"))
                y = F.relu(bn(F.conv2d(y, p[f"{b}.conv2.weight"], stride=s,
                                       padding=1), f"{b}.bn2"))
                y = bn(F.conv2d(y, p[f"{b}.conv3.weight"]), f"{b}.bn3")
                if j == 0:
                    x = bn(F.conv2d(x, p[f"{b}.downsample.0.weight"],
                                    stride=s), f"{b}.downsample.1")
                x = F.relu(y + x)
        x = F.adaptive_avg_pool2d(x, 1).flatten(1)
        return F.linear(x, p["fc.weight"], p["fc.bias"])
