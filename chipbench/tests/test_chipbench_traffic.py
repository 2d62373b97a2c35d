"""Traffic and data are reproducible from --seed, and differ between
seeds."""
import pytest
import torch

from chipbench import harness, reference

SEED = 2 ** 33 + 17                # larger than 32 signed bits


def drv(name):
    return harness.load_module("traffic", name)


def test_arrivals_reproducible():
    a = drv("open_serve").arrivals(200.0, 5.0, 8, SEED)
    assert a == drv("open_serve").arrivals(200.0, 5.0, 8, SEED)
    b = drv("open_serve").arrivals(200.0, 5.0, 8, SEED + 1)
    assert a != b
    assert all(0 < t < 5.0 and 1 <= n <= 8 for t, n in a)
    assert 800 < len(a) < 1200


def test_every_seed_offers_the_same_requests():
    a = drv("open_serve").arrivals(200.0, 5.0, 8, 1)
    b = drv("open_serve").arrivals(200.0, 5.0, 8, 2)
    assert len(a) == len(b)
    assert sorted(n for _, n in a) == sorted(n for _, n in b)
    assert abs(a[-1][0] - b[-1][0]) < 1e-9


def test_arrivals_follow_synthetic_trace():
    """The draw is the port's ``synthetic_trace``'s, in another order."""
    from repro_torch.launch.batcher import synthetic_trace
    a = drv("open_serve").arrivals(50.0, 2.0, 8, 7)
    tr = synthetic_trace(n_requests=drv("open_serve").n_drawn(50.0, 2.0),
                         max_batch=8, rate_rps=50.0,
                         seed=drv("open_serve").DRAW_SEED)
    tr = [t for t in tr if t.t < 2.0]
    assert sorted(t.batch for t in tr) == sorted(b for _, b in a)
    def gaps(times):
        return sorted(b - a for a, b in zip([0.0] + times[:-1], times))
    mine = gaps([t for t, _ in a])
    theirs = gaps([t.t for t in tr])
    assert len(mine) == len(theirs)
    assert all(abs(x - y) < 1e-9 for x, y in zip(theirs, mine))


def test_sample_reproducible():
    s = drv("open_serve").sample(1000, 64, SEED)
    assert s == drv("open_serve").sample(1000, 64, SEED)
    assert len(set(s)) == 64


def test_inputs_and_params_reproducible():
    cpu = torch.device("cpu")
    x = reference.make_input((2, 3, 8, 8), SEED, 5, cpu)
    assert torch.equal(x, reference.make_input((2, 3, 8, 8), SEED, 5, cpu))
    assert not torch.equal(x, reference.make_input((2, 3, 8, 8), SEED, 6,
                                                   cpu))
    layers = [{"name": "a", "C": 3, "Cout": 4, "k": 3},
              {"name": "b", "C": 4, "Cout": 5, "k": 3}]
    k1, b1 = reference.make_params(layers, SEED, cpu)
    k2, b2 = reference.make_params(layers, SEED, cpu)
    assert all(torch.equal(k1[n], k2[n]) and torch.equal(b1[n], b2[n])
               for n in "ab")
    # He-normal: the kernel's spread follows its fan-in
    k, _ = reference.make_params([{"name": "c", "C": 256, "Cout": 256,
                                   "k": 3}], SEED, cpu)
    assert abs(k["c"].std().item() - (2 / (256 * 9)) ** 0.5) < 1e-3


def test_tf32_round():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1 - 2 ** -10,
                      float("inf")])
    y = reference.tf32_round(x)
    assert y.tolist() == [1.0, 1.0, 1 + 2 ** -9, -1 - 2 ** -10,
                          float("inf")]


def test_sweep_verdict():
    """A rate counts as sustained only where every seed's run at it, and at
    every lower rate, was."""
    from chipbench import sweep
    assert sweep.growth([0.0, 1.0, 2.0, 3.0], [0.01, 0.02, 0.03, 0.04]) \
        == pytest.approx(0.03)
    assert sweep.growth([0.0, 1.0, 2.0], [0.02, 0.01, 0.02]) == 0.0
    assert sweep.sustained(0.005, 0.010, 97.0, 100.0)
    assert not sweep.sustained(0.0051, 0.010, 100.0, 100.0)
    assert not sweep.sustained(0.0, 0.010, 96.0, 100.0)
    runs = [{"rate_rps": r, "sustained": ok} for r, ok in
            [(160, True), (160, True), (200, True), (200, True),
             (215, True), (215, False), (230, True), (230, True)]]
    assert sweep.highest_sustained(runs) == 200
    assert sweep.highest_sustained(runs[:1] + [
        {"rate_rps": 100, "sustained": False}]) is None
