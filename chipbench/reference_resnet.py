"""The plain reference of the ResNet-50 v1.5 configuration, its data, and
its work count.

Plain PyTorch only: ``F.conv2d`` with each conv's stride, eval-mode
``F.batch_norm`` on the unfolded parameters, ReLU, ``F.max_pool2d(3, 2,
1)``, the global average pool and ``F.linear``, walked from the
configuration file's conv list (block and role of each conv).  It imports
nothing of the program: the program is handed the same unfolded
parameters (``make_params``) and folds batch norm itself.  Float32 with
TF32 off (``reference.set_precision``), or, as the control, every conv's
and the classifier's operands rounded to TF32 and accumulated in float32.
Departures from the published model: random weights (the configuration's
``assumed``), no softmax (the logits are compared).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference import generator, tf32_round

BN_STATS = ("weight", "bias", "running_mean", "running_var")


# --------------------------------------------------------------------------
# Data: made from the seed, handed to both sides
# --------------------------------------------------------------------------

def make_params(cfg: dict, seed: int, device) -> dict:
    """Unfolded parameters under torchvision's names, as the
    configuration's ``assumed`` states them: one normal and one uniform
    draw on ``device``, cut into views."""
    normal, uniform = [], []            # (name, shape, std) / (name, lo, hi)
    for l in cfg["layers"]:
        co, bn = l["Cout"], l["bn"]
        normal.append((f"{l['name']}.weight", (co, l["C"], l["k"], l["k"]),
                       math.sqrt(2.0 / (l["C"] * l["k"] * l["k"]))))
        normal.append((f"{bn}.bias", (co,), 0.1))
        normal.append((f"{bn}.running_mean", (co,), 0.1))
        lo, hi = (0.1, 0.3) if l["role"] == "expand" else (0.75, 1.25)
        uniform.append((f"{bn}.weight", (co,), lo, hi))
        uniform.append((f"{bn}.running_var", (co,), 0.75, 1.25))
    fc = cfg["classifier"]
    normal.append(("fc.weight", (fc["out"], fc["in"]),
                   1.0 / math.sqrt(fc["in"])))
    normal.append(("fc.bias", (fc["out"],), 0.01))
    g = generator(device, seed, 3)
    zn = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g,
                     device=device)
    zu = torch.rand(sum(math.prod(s) for _, s, _, _ in uniform),
                    generator=g, device=device)
    p, off = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        p[name] = zn[off:off + n].view(shape).mul_(std)
        off += n
    off = 0
    for name, shape, lo, hi in uniform:
        n = math.prod(shape)
        p[name] = zu[off:off + n].view(shape).mul_(hi - lo).add_(lo)
        off += n
    return p


def input_shape(cfg: dict, batch: int) -> tuple:
    l0 = cfg["layers"][0]
    return (batch, l0["C"], l0["H"], l0["W"])


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _conv(x, w, layer, tf32):
    if tf32:
        x, w = tf32_round(x), tf32_round(w)
    return F.conv2d(x, w, stride=layer["stride"], padding=layer["pad"])


def _bn(y, p, name, eps):
    return F.batch_norm(y, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=False, eps=eps)


def forward(cfg: dict, p: dict, x, *, tf32: bool = False):
    """Logits of the images ``x``: the stem, each block's reduce, 3x3 and
    expand convs with the shortcut (its projection where the block has
    one) added before the last ReLU, the pools, the classifier."""
    eps = cfg["bn_eps"]

    def conv_bn(x, l):
        return _bn(_conv(x, p[f"{l['name']}.weight"], l, tf32), p, l["bn"],
                   eps)

    blocks: dict = {}
    for l in cfg["layers"]:
        blocks.setdefault(l["block"], {})[l["role"]] = l
    pool = next(q for q in cfg["pools"] if q["kind"] == "max")
    with torch.no_grad():
        x = F.relu(conv_bn(x, blocks.pop("stem")["stem"]))
        x = F.max_pool2d(x, pool["k"], pool["stride"], pool["pad"])
        for b in blocks.values():
            y = F.relu(conv_bn(x, b["reduce"]))
            y = F.relu(conv_bn(y, b["3x3"]))
            y = conv_bn(y, b["expand"])
            shortcut = conv_bn(x, b["projection"]) if "projection" in b \
                else x
            x = F.relu(y + shortcut)
        x = x.mean(dim=(2, 3))
        w = p["fc.weight"]
        if tf32:
            x, w = tf32_round(x), tf32_round(w)
        return F.linear(x, w, p["fc.bias"])


# --------------------------------------------------------------------------
# Work
# --------------------------------------------------------------------------

def out_hw(layer) -> tuple:
    """(Ho, Wo) of a conv with its stride and symmetric padding."""
    s, p, k = layer["stride"], layer["pad"], layer["k"]
    return ((layer["H"] + 2 * p - k) // s + 1,
            (layer["W"] + 2 * p - k) // s + 1)


def conv_flops(layer) -> int:
    """2*C'*C*Ho*Wo*k*k of one image, at the conv's stride."""
    ho, wo = out_hw(layer)
    return 2 * layer["Cout"] * layer["C"] * ho * wo * layer["k"] ** 2


def model_flops(cfg: dict, images: int) -> int:
    """Direct FLOPs of ``images`` through every conv and the classifier
    (multiply-adds at 2 FLOPs; pools, norms and adds not counted)."""
    fc = cfg["classifier"]
    per = sum(conv_flops(l) for l in cfg["layers"]) + 2 * fc["in"] * fc["out"]
    return images * per


def fft_layers(cfg: dict) -> list:
    """The convs the FFT backend runs: unit stride, k >= 3."""
    return [l for l in cfg["layers"] if l["stride"] == 1 and l["k"] >= 3]
