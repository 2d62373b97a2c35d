"""How the benchmark drives the program (``repro_torch``): the conv
configurations as the port's planned layers.  The layer list, the pools
and the epilogue come from the benchmark's configuration file; everything
that computes is the port's.  Backend ``fft-cuda`` is pinned: no tuner
sweep runs.
"""
from __future__ import annotations

BACKEND = "fft-cuda"


def epilogue(cfg):
    from repro_torch.conv import Epilogue
    ep = cfg["epilogue"]
    return Epilogue(bias=ep["bias"], activation=ep["activation"])


def network(cfg, layers, batch: int) -> tuple:
    """The port's ``NetworkConv`` specs of ``layers`` at ``batch``."""
    from repro_torch.conv import NetworkConv
    ep = epilogue(cfg)
    return tuple(NetworkConv(name=l["name"],
                             x_shape=(batch, l["C"], l["H"], l["W"]),
                             k_shape=(l["Cout"], l["C"], l["k"], l["k"]),
                             padding=l["pad"], epilogue=ep)
                 for l in layers)


def trunk_forward(layers, biases):
    """``forward(prepared, x)`` of the trunk: each prepared layer with its
    fused bias and ReLU, the port's 2x2 max-pool where the configuration
    puts one."""
    from repro_torch.models.layers import maxpool2x2
    pools = frozenset(l["name"] for l in layers if l.get("pool_after"))

    def forward(prepared, x):
        for name in prepared:
            x = prepared[name](x, bias=biases[name])
            if name in pools:
                x = maxpool2x2(x)
        return x
    return forward


def plan_layer(cfg, layer, batch: int):
    """The port's ``ConvPlan`` of one layer at ``batch``."""
    from repro_torch.conv import plan_conv
    return plan_conv((batch, layer["C"], layer["H"], layer["W"]),
                     (layer["Cout"], layer["C"], layer["k"], layer["k"]),
                     padding=layer["pad"], backend=BACKEND,
                     epilogue=epilogue(cfg))
