"""The served VGG trunk through repro_torch held against repro.

The trunk of ``serve --convnet vgg`` scaled to a 32x32 input with channels
divided by 16 (the first layer keeps C=3), batch 1: the same numpy weights
go to JAX's ``fft-pallas`` network (Pallas in interpret mode, the forward
under one ``jax.jit``) and, through ``convert.params_from_jax``,
to the port's ``fft-cuda`` network on the CPU (the kernels' plain
versions).  Outputs agree to 1e-4 relative to max|y|; every forward runs
the CGEMM and the fused inverse once per layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp

from repro.configs.paper_convs import network_convs as j_network_convs
from repro.conv import plan_network as j_plan_network
from repro.launch import serve as jserve
from repro_torch import convert
from repro_torch.configs.paper_convs import network_convs
from repro_torch.conv import plan_network, stage_trace
from repro_torch.launch import serve

IMAGE, BATCH, SEED = 32, 1, 0


def _narrow(layers):
    return [dataclasses.replace(l, C=l.C if l.C == 3 else l.C // 16,
                                Cout=l.Cout // 16) for l in layers]


def test_vgg_slice_matches_jax():
    layers = _narrow(serve._vgg_scale(IMAGE))
    assert [dataclasses.astuple(l) for l in layers] == [
        dataclasses.astuple(l) for l in _narrow(jserve._vgg_scale(IMAGE))]
    jnet = j_plan_network(j_network_convs(layers, BATCH),
                          backend="fft-pallas")
    rng = np.random.default_rng(SEED)
    ks = {n: (0.05 * rng.standard_normal(jnet[n].k_shape)).astype(
        np.float32) for n in jnet}
    bs = {n: (0.05 * rng.standard_normal((jnet[n].spec.Cout,))).astype(
        np.float32) for n in jnet}
    x = rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
    jprep = jnet.prepare({n: jnp.asarray(k) for n, k in ks.items()},
                         weights_version=0)
    jforward = jserve._vgg_forward({n: jnp.asarray(b) for n, b in bs.items()})
    yj = np.asarray(jax.jit(lambda a: jforward(jprep, a))(jnp.asarray(x)))

    kernels, biases = convert.params_from_jax(ks, bs, device="cpu")
    net = plan_network(network_convs(layers, BATCH), backend="fft-cuda")
    assert net.layer_names == jnet.layer_names
    prepared = net.prepare(kernels, weights_version=0)
    with stage_trace() as counts:
        y = serve._vgg_forward(biases)(prepared, torch.from_numpy(x))
    assert counts["cgemm"] == 9 and counts["output_inverse"] == 9
    assert counts.get("kernel_transform", 0) == 0
    assert tuple(y.shape) == yj.shape == (BATCH, 32, 1, 1)
    scale = np.abs(yj).max()
    np.testing.assert_allclose(y.numpy() / scale, yj / scale, atol=1e-4)


def test_serve_entry_point_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` end to end on the host at a
    small size: the planned trunk, one prepare sweep per weights version,
    the request loop with per-request timing."""
    res = serve.main(["--convnet", "vgg", "--conv-backend", "fft-cuda",
                      "--image", "32", "--batch", "1", "--gen", "2",
                      "--timing", "per-request", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "9 layers" in out and "per-request latency" in out
    assert tuple(res.y.shape) == (1, 512, 1, 1)
    assert bool(torch.isfinite(res.y).all())
    assert len(res.latencies_s) == 2


def test_entry_points_want_a_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--image", "32", "--batch", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({}, {})
