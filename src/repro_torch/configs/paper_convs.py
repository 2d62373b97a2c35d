"""Table I of the paper: 17 unit-stride convolutional layers from
AlexNet (A), VGG (V) and ResNet (R), each at batch sizes 32/64/128."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    C: int
    Cout: int
    H: int
    W: int
    kh: int
    kw: int
    pad: int = 1          # unit-stride, 'same'-style padding as in the nets


# name, C, C', H_i x W_i, k
def network_convs(layers, batch, *, bias=True, activation="relu"):
    """Table-I layers -> ``NetworkConv`` specs for
    ``repro_torch.conv.plan_network``.

    Each layer carries the fused conv+bias+activation epilogue the source
    nets apply (VGG/AlexNet/ResNet all follow every conv with bias+ReLU),
    so planning the network fuses the whole elementwise tail into stage 4.
    """
    from repro_torch.conv import Epilogue, NetworkConv
    ep = Epilogue(bias=bias, activation=activation)
    return tuple(
        NetworkConv(name=l.name,
                    x_shape=(batch, l.C, l.H, l.W),
                    k_shape=(l.Cout, l.C, l.kh, l.kw),
                    padding=l.pad, epilogue=ep)
        for l in layers)


def vgg_network(batch, *, bias=True, activation="relu"):
    """The VGG conv trunk of Table I as one plannable network (the per-block
    max-pools between entries are elementwise-cheap and stay outside the
    conv plans; the Table-I geometries already reflect the pooled sizes)."""
    vgg = [l for l in TABLE1 if l.name.startswith("V")]
    return network_convs(vgg, batch, bias=bias, activation=activation)


TABLE1 = (
    ConvLayer("Vconv1.1", 3, 64, 224, 224, 3, 3),
    ConvLayer("Vconv1.2", 64, 64, 224, 224, 3, 3),
    ConvLayer("Vconv2.1", 64, 128, 112, 112, 3, 3),
    ConvLayer("Vconv2.2", 128, 128, 112, 112, 3, 3),
    ConvLayer("Vconv3.1", 128, 256, 56, 56, 3, 3),
    ConvLayer("Vconv3.2", 256, 256, 56, 56, 3, 3),
    ConvLayer("Vconv4.1", 256, 512, 28, 28, 3, 3),
    ConvLayer("Vconv4.2", 512, 512, 28, 28, 3, 3),
    ConvLayer("Vconv5", 512, 512, 14, 14, 3, 3),
    ConvLayer("Aconv2", 48, 128, 27, 27, 5, 5, pad=2),
    ConvLayer("Aconv3", 256, 384, 13, 13, 3, 3),
    ConvLayer("Aconv4", 192, 192, 13, 13, 3, 3),
    ConvLayer("Aconv5", 192, 128, 13, 13, 3, 3),
    ConvLayer("Rconv2.2", 64, 64, 56, 56, 3, 3),
    ConvLayer("Rconv3.2", 128, 128, 28, 28, 3, 3),
    ConvLayer("Rconv4.2", 256, 256, 14, 14, 3, 3),
    ConvLayer("Rconv5.2", 512, 512, 7, 7, 3, 3),
)

BATCH_SIZES = (32, 64, 128)
