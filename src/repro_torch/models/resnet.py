"""ResNet-50 v1.5 inference through the port's conv system.

The 50-layer network of He et al. (arXiv:1512.03385, Table 1) in the form
torchvision's ``resnet50`` and the MLPerf Inference image-classification
benchmark use ("v1.5"): each downsampling bottleneck puts its stride on
the 3x3 conv, not on the first 1x1.  A 7x7/2 stem, a 3x3/2 max-pool, four
stages of 3, 4, 6 and 3 bottlenecks at widths 64, 128, 256 and 512
(expansion 4), a global average pool and a 1000-way classifier.

Every one of its 53 convs is a planned layer (``network_convs``):

- the 13 unit-stride 3x3 convs take the FFT backend (``fft-cuda`` unless
  asked otherwise), with their folded bias and ReLU fused into the inverse;
- the stem, the 1x1 reduce and expand convs, the four 1x1 projections and
  the three strided 3x3 convs take ``direct`` (cuDNN), with the bias,
  residual and ReLU tail in the plan's epilogue.

Batch norm runs in eval mode, folded into each conv's kernel and bias once
a weights version (``fold_batchnorm``: the checkpoint's unfolded
parameters, as torchvision names them, in).  Each bottleneck's expand conv
takes its shortcut (the block's input, or its projection) as the
epilogue's ``residual=``: the forward launches no add of its own.

    params = init_params(seed, device=device)          # or a checkpoint
    folded = fold_batchnorm(params)
    eng = ServeEngine(lambda b: network_convs(b), folded.kernels,
                      policy=BucketPolicy(max_batch=128, min_batch=128),
                      forward=make_forward(folded), backend="fft-cuda")

``width_div`` divides every width (the host tests' small form); the
topology, strides and roles stay.  Inference only: training would need
the batch statistics' backward, which no epilogue fuses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as TF

from repro_torch.conv.epilogue import Epilogue
from repro_torch.conv.netplan import NetworkConv
from repro_torch.core.trace import _count, span

STEM = 64
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
EXPANSION = 4
NUM_CLASSES = 1000
IMAGE = 224
BN_EPS = 1e-5
FFT_BACKEND = "fft-cuda"

_RELU = Epilogue(bias=True, activation="relu")
EPILOGUES = {"stem": _RELU, "reduce": _RELU, "3x3": _RELU,
             "expand": Epilogue(bias=True, residual=True, activation="relu"),
             "projection": Epilogue(bias=True)}


@dataclasses.dataclass(frozen=True)
class Conv:
    """One conv of the network: its checkpoint name, its batch norm's, its
    geometry at the input it sees, the block it belongs to and its role
    there (``stem``, ``reduce``, ``3x3``, ``expand`` or ``projection``)."""
    name: str
    bn: str
    C: int
    Cout: int
    k: int
    stride: int
    pad: int
    H: int
    W: int
    block: str
    role: str

    @property
    def fft(self) -> bool:
        """Whether the FFT backend runs it: unit stride, k >= 3."""
        return self.stride == 1 and self.k >= 3


@dataclasses.dataclass(frozen=True)
class Block:
    """The conv names of one bottleneck (``projection`` None where the
    shortcut is the block's input)."""
    name: str
    reduce: str
    mid: str
    expand: str
    projection: Optional[str]


def blocks() -> tuple:
    """The 16 bottlenecks in order, named as torchvision names them."""
    out = []
    for i, (_, n, _) in enumerate(STAGES, start=1):
        for j in range(n):
            b = f"layer{i}.{j}"
            out.append(Block(b, f"{b}.conv1", f"{b}.conv2", f"{b}.conv3",
                             f"{b}.downsample.0" if j == 0 else None))
    return tuple(out)


def convs(*, image: int = IMAGE, width_div: int = 1) -> tuple:
    """The 53 convs in execution order, at a square ``image`` input and
    every width divided by ``width_div``."""
    if image % 32:
        raise ValueError(f"image must be a multiple of 32, got {image}")
    out = []
    stem = STEM // width_div
    s = image // 2
    out.append(Conv("conv1", "bn1", 3, stem, 7, 2, 3, image, image,
                    "stem", "stem"))
    s //= 2                                   # the 3x3/2 max-pool
    c_in = stem
    for i, (width, n, stride) in enumerate(STAGES, start=1):
        w = width // width_div
        c_out = w * EXPANSION
        for j in range(n):
            b = f"layer{i}.{j}"
            st = stride if j == 0 else 1
            out.append(Conv(f"{b}.conv1", f"{b}.bn1", c_in, w, 1, 1, 0,
                            s, s, b, "reduce"))
            out.append(Conv(f"{b}.conv2", f"{b}.bn2", w, w, 3, st, 1,
                            s, s, b, "3x3"))
            if j == 0:
                out.append(Conv(f"{b}.downsample.0", f"{b}.downsample.1",
                                c_in, c_out, 1, st, 0, s, s, b,
                                "projection"))
            s_out = (s - 1) // st + 1
            out.append(Conv(f"{b}.conv3", f"{b}.bn3", w, c_out, 1, 1, 0,
                            s_out, s_out, b, "expand"))
            s, c_in = s_out, c_out
    return tuple(out)


def network_convs(batch: int, *, image: int = IMAGE, width_div: int = 1,
                  fft_backend: Optional[str] = FFT_BACKEND) -> tuple:
    """The ``NetworkConv`` of every conv at ``batch``: ``fft_backend`` for
    the unit-stride convs with k >= 3 (``None``: the network-wide
    backend), ``direct`` for the 1x1 and strided ones."""
    out = []
    for c in convs(image=image, width_div=width_div):
        if c.fft:
            over = () if fft_backend is None else (("backend", fft_backend),)
        else:
            over = (("backend", "direct"),)
        out.append(NetworkConv(name=c.name, x_shape=(batch, c.C, c.H, c.W),
                               k_shape=(c.Cout, c.C, c.k, c.k),
                               padding=c.pad, epilogue=EPILOGUES[c.role],
                               overrides=over, stride=c.stride))
    return tuple(out)


# --------------------------------------------------------------------------
# Parameters: unfolded, as a checkpoint holds them; folded at prepare
# --------------------------------------------------------------------------

def init_params(seed: int, *, device=None, width_div: int = 1) -> dict:
    """Random unfolded parameters under torchvision's names, from
    ``seed``: He-normal conv kernels; batch norms with running mean
    N(0, 0.1^2), running variance U(0.75, 1.25), bias N(0, 0.1^2) and
    scale U(0.75, 1.25), but U(0.1, 0.3) on each branch's last norm
    (``bn3``), the small scale that zero-scale initialisation starts from
    and trained networks end near, so that the residual stream grows by a
    fraction a block; a normal classifier (std 1/sqrt(fan-in), bias
    N(0, 0.01^2))."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    p = {}
    cs = convs(width_div=width_div)
    for c in cs:
        p[f"{c.name}.weight"] = normal((c.Cout, c.C, c.k, c.k),
                                       math.sqrt(2.0 / (c.C * c.k * c.k)))
        lo, hi = (0.1, 0.3) if c.role == "expand" else (0.75, 1.25)
        p[f"{c.bn}.weight"] = uniform((c.Cout,), lo, hi)
        p[f"{c.bn}.bias"] = normal((c.Cout,), 0.1)
        p[f"{c.bn}.running_mean"] = normal((c.Cout,), 0.1)
        p[f"{c.bn}.running_var"] = uniform((c.Cout,), 0.75, 1.25)
    feat = cs[-1].Cout
    p["fc.weight"] = normal((NUM_CLASSES, feat), 1.0 / math.sqrt(feat))
    p["fc.bias"] = normal((NUM_CLASSES,), 0.01)
    return p


class Folded(NamedTuple):
    """Batch norm folded in: each conv's kernel and bias by conv name, and
    the classifier."""
    kernels: dict
    biases: dict
    fc_weight: torch.Tensor
    fc_bias: torch.Tensor


def fold_batchnorm(params: dict, *, eps: float = BN_EPS) -> Folded:
    """Eval-mode batch norm folded into the conv before it: with
    ``s = gamma / sqrt(var + eps)``, the kernel ``w * s`` (per output
    channel) and the bias ``beta - mean * s``, worked out in float64 and
    stored in the kernel's dtype.  Run once a weights version, before the
    network is prepared."""
    kernels, biases = {}, {}
    with span("resnet/fold"), torch.no_grad():
        names = [k[:-len(".weight")] for k, v in params.items()
                 if k.endswith(".weight") and v.dim() == 4]
        for name in names:
            bn = _bn_of(name)
            w = params[f"{name}.weight"]
            scale = (params[f"{bn}.weight"].double()
                     / torch.sqrt(params[f"{bn}.running_var"].double() + eps))
            kernels[name] = (w.double() * scale[:, None, None, None]).to(
                w.dtype).contiguous()
            biases[name] = (params[f"{bn}.bias"].double()
                            - params[f"{bn}.running_mean"].double()
                            * scale).to(w.dtype)
    return Folded(kernels, biases, params["fc.weight"], params["fc.bias"])


def _bn_of(conv: str) -> str:
    """The batch norm after a conv, by torchvision's names."""
    if conv.endswith("downsample.0"):
        return conv[:-1] + "1"
    head, _, tail = conv.rpartition("conv")
    return f"{head}bn{tail}"


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _conv(prepared, name, x, **operands):
    layer = prepared[name]
    plan = layer.plan
    _count(("backend", plan.backend))
    _count(("conv", plan.backend, plan.stride[0], plan.spec.kh))
    return layer(x, **operands)


def forward(prepared, x, folded: Folded):
    """Logits of the images ``x`` (B, 3, H, W) through the prepared
    network (``NetworkPlan.prepare`` of ``folded.kernels``, or a loaded
    artifact)."""
    b = folded.biases
    x = _conv(prepared, "conv1", x, bias=b["conv1"])
    x = TF.max_pool2d(x, 3, 2, 1)
    for blk in blocks():
        with span("resnet/block"):
            shortcut = x if blk.projection is None else _conv(
                prepared, blk.projection, x, bias=b[blk.projection])
            y = _conv(prepared, blk.reduce, x, bias=b[blk.reduce])
            y = _conv(prepared, blk.mid, y, bias=b[blk.mid])
            x = _conv(prepared, blk.expand, y, bias=b[blk.expand],
                      residual=shortcut)
    return TF.linear(x.mean(dim=(2, 3)), folded.fc_weight, folded.fc_bias)


def make_forward(folded: Folded):
    """``forward(prepared, x)`` over ``folded``: the form ``ServeEngine``
    captures."""
    def run(prepared, x):
        return forward(prepared, x, folded)
    return run
