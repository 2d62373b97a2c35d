"""The frozen work arithmetic against hand-computed figures."""
import json
import pathlib

import pytest

from chipbench import work

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def layers(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["layers"]


def test_freq_points_at_tile_16():
    assert work.FREQ == 130


@pytest.mark.parametrize("name, gflop", [("vgg16-t1", 21.444820992),
                                         ("paper-table1", 23.079555072)])
def test_model_flops_an_image(name, gflop):
    assert work.model_flops(layers(name), 1) == round(gflop * 1e9)


def test_training_flops_an_image():
    # forward + dk of all nine layers + dx of layers 2-9
    v = layers("vgg16-t1")
    assert work.model_flops(v, 1, train=True) == 3 * 21444820992 - \
        2 * 64 * 3 * 224 * 224 * 9 == 64161054720


def test_cgemm_work_of_vconv1_2():
    l = layers("vgg16-t1")[1]                  # 64 -> 64 at 224, k 3
    assert work.tiles(l, 64) == 64 * 16 * 16
    flops, nbytes = work.cgemm_work(l, 64)
    assert flops == 6 * 130 * 16384 * 64 * 64
    assert nbytes == 8 * 130 * (16384 * 64 + 64 * 64 + 16384 * 64)


def test_tiles_of_the_5x5_layer():
    a = next(l for l in layers("paper-table1") if l["name"] == "Aconv2")
    assert work.out_hw(a) == (27, 27)
    assert work.tiles(a, 1) == 3 * 3          # 12 outputs a tile


def test_least_time_takes_the_larger_bound():
    assert work.least_s(67e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_dft_work_is_bytes_bound():
    for l in layers("paper-table1"):
        flops, nbytes = work.dft_forward_work(l, 64)
        assert flops / work.PEAK_F32_FLOPS < nbytes / work.PEAK_HBM_BYTES


def test_conv_least_counts_each_pass():
    l = layers("vgg16-t1")[4]
    one = work.conv_least_s([{"layer": l, "batch": 32, "n": 1,
                              "pass": "fwd"}], "cgemm")
    both = work.conv_least_s([{"layer": l, "batch": 32, "n": 3,
                               "pass": "fwd"},
                              {"layer": l, "batch": 32, "n": 3,
                               "pass": "dx"},
                              {"layer": l, "batch": 32, "n": 3,
                               "pass": "kernel"}], "cgemm")
    assert both == pytest.approx(6 * one)
    kern = work.conv_least_s([{"layer": l, "batch": 32, "n": 1,
                               "pass": "kernel"}], "dft")
    assert kern == pytest.approx(
        (4 * 256 * 128 * 9 + 8 * 130 * 128 * 256) / work.PEAK_HBM_BYTES)
