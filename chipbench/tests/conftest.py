"""Fixtures of the benchmark's CPU tests: the program on the path, and the
cells shrunk to a size the host runs in seconds."""
import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def shrink(cell, cfg):
    """``cell`` and ``cfg`` at a host-sized scale: images 1/7 of their side
    (224 -> 32, so that every pool still halves), channels 1/8, batches of
    2, a lower rate.  The widths change, so this is never a cell."""
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    for l in cfg["layers"]:
        l["H"], l["W"] = max(1, l["H"] // 7), max(1, l["W"] // 7)
        if l["C"] > 3:
            l["C"] = max(1, l["C"] // 8)
        l["Cout"] = max(1, l["Cout"] // 8)
    t = cell["traffic"]
    if "batch" in t:
        t["batch"] = 2
    if "rate_rps" in t:
        t.update(rate_rps=20.0, max_batch=2)
    if "sample" in t:
        t["sample"] = 4
    return cell, cfg


@pytest.fixture
def small():
    """``small(name)``: the shrunk (cell, cfg) of a cell."""
    from chipbench import harness

    def get(name):
        return shrink(*harness.load_cell(name))
    return get


@pytest.fixture
def card():
    """The CUDA card; the test skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
