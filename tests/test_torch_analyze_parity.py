"""The port's plan-lint against the JAX package's, plan for plan.

The same plans — ``(2, 3, 18, 18) x (4, 3, 3, 3)`` and ``(4, 4, 20, 20) x
(4, 4, 3, 3)``, ``padding=1`` — go through ``repro.conv.analyze.analyze``
and ``repro_torch.conv.analyze.analyze`` for the pairs ``direct`` <->
``direct``, ``fft-torch`` <-> ``fft-xla`` and ``fft-cuda`` <->
``fft-pallas``, each on local/nfft/wfft (a (1, 1) mesh: a one-rank gloo
group here, ``make_mesh`` there) and each variant full / prepared / fused
epilogue / bf16 / complex spectrum / ``slab:2``.  Each case holds:

- ``stage_counts``, ``cgemm_dtypes``, ``cgemm_shapes`` and ``has_f64``
  equal;
- ``collective_bytes`` equal exactly;
- the reference's ``all_to_all`` and ``psum`` counts exactly twice the
  port's (the port moves the real and imaginary planes in one buffer),
  ``ppermute``/``all_gather`` 0 in both, ``collective_dtypes`` halved per
  dtype, ``elision`` halved for the collectives and equal for
  ``kernel_transform``;
- the ``spectrum_delta`` and ``overlap_delta`` ratios within 1e-12;
- ``check().ok`` equal, and the names of the invariants checked equal.

``peak_live_bytes`` is a documented difference (a liveness walk of a
jaxpr there, a live-storage tally of the ops run here): the port's
estimate is held between the bytes of the inputs plus the output and the
sum of every op output's bytes (the fake inputs among them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.conv as jconv
from repro.compat import make_mesh as jmake_mesh
from repro.conv.analyze import analyze as janalyze
import repro_torch.conv as tconv
from repro_torch.conv.analyze import analyze as tanalyze
from repro_torch.core.dft import num_freq_real
from repro_torch.launch import mesh as tmesh

PAIRS = [("direct", "direct"), ("fft-torch", "fft-xla"),
         ("fft-cuda", "fft-pallas")]
SHAPES = [((2, 3, 18, 18), (4, 3, 3, 3)), ((4, 4, 20, 20), (4, 4, 3, 3))]
VARIANTS = ["full", "prepared", "epilogue", "bf16", "complex", "slab:2"]
RATIO_TOL = 1e-12


def _cases():
    for ours, ref in PAIRS:
        for schedule in (("local",) if ours == "direct"
                         else ("local", "nfft", "wfft")):
            for variant in VARIANTS:
                if ours == "direct" and variant == "complex":
                    continue                  # no spectrum on direct
                if variant == "slab:2" and schedule == "local":
                    continue                  # overlap needs a mesh
                for i in range(len(SHAPES)):
                    yield pytest.param(
                        ours, ref, schedule, variant, i,
                        id=f"{ours}-{schedule}-{variant}-{i}")


@pytest.fixture(scope="module")
def meshes():
    """A (1, 1) mesh of each package: a one-rank gloo group here."""
    tmesh.start_process_group("gloo")
    try:
        yield tmesh.make_host_mesh(1, 1), jmake_mesh((1, 1),
                                                      ("data", "model"))
    finally:
        tmesh.destroy_process_group()


def _knobs(pkg, variant):
    """The plan_conv keywords of a variant, in package ``pkg``'s types."""
    if variant == "epilogue":
        return {"epilogue": pkg.Epilogue(bias=True, activation="relu")}
    if variant == "bf16":
        return {"compute_dtype": (torch.bfloat16 if pkg is tconv
                                  else jnp.bfloat16)}
    if variant == "complex":
        return {"spectrum": "complex"}
    if variant == "slab:2":
        return {"overlap": "slab:2"}
    return {}


class _OutputBytes(TorchDispatchMode):
    """The bytes of every op output dispatched under it."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += sum(t.numel() * t.element_size()
                          for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor))
        return out


def _halved(ref: dict, ours: dict) -> bool:
    keys = set(ref) | set(ours)
    return all(ref.get(k, 0) == 2 * ours.get(k, 0) for k in keys)


@pytest.mark.parametrize("ours,ref,schedule,variant,shape", _cases())
def test_profiles_agree_with_the_reference(meshes, ours, ref, schedule,
                                           variant, shape):
    tmesh_, jmesh = meshes
    x_shape, k_shape = SHAPES[shape]
    sharded = schedule != "local"
    prepared = variant == "prepared"
    tplan = tconv.plan_conv(x_shape, k_shape, padding=1, backend=ours,
                            schedule=schedule,
                            mesh=tmesh_ if sharded else None,
                            **_knobs(tconv, variant))
    jplan = jconv.plan_conv(x_shape, k_shape, padding=1, backend=ref,
                            schedule=schedule,
                            mesh=jmesh if sharded else None,
                            **_knobs(jconv, variant))
    jp = janalyze(jplan, prepared=prepared)
    with _OutputBytes() as outputs:
        tp = tanalyze(tplan, prepared=prepared, device="cpu")

    assert tp.stage_counts == jp.stage_counts
    assert tp.cgemm_dtypes == jp.cgemm_dtypes
    assert tp.cgemm_shapes == jp.cgemm_shapes
    assert tp.has_f64 == jp.has_f64 is False
    assert tp.collective_bytes == jp.collective_bytes
    for name in ("all_to_all", "psum"):
        assert jp.collectives[name] == 2 * tp.collectives[name]
    for name in ("ppermute", "all_gather"):
        assert jp.collectives[name] == tp.collectives[name] == 0
    assert set(tp.collectives) == set(jp.collectives)
    assert set(tp.collective_dtypes) == set(jp.collective_dtypes)
    for name, dtypes in jp.collective_dtypes.items():
        assert _halved(dtypes, tp.collective_dtypes[name])
    if sharded and variant in ("full", "prepared", "bf16"):
        assert sum(tp.collectives.values()) > 0      # something to compare
    assert (tp.elision is None) == (jp.elision is None)
    if jp.elision is not None:
        assert tp.elision["kernel_transform"] \
            == jp.elision["kernel_transform"]
        assert _halved({k: v for k, v in jp.elision.items()
                        if k != "kernel_transform"},
                       {k: v for k, v in tp.elision.items()
                        if k != "kernel_transform"})
    for delta in ("spectrum_delta", "overlap_delta"):
        j, t = getattr(jp, delta), getattr(tp, delta)
        assert (t is None) == (j is None)
        if j is not None:
            assert t["collective_bytes"] == j["collective_bytes"]
            assert t["twin_collective_bytes"] == j["twin_collective_bytes"]
            assert abs(t["ratio"] - j["ratio"]) <= RATIO_TOL
    assert tp.num_slabs == jp.num_slabs and tp.overlap == jp.overlap
    jr, tr = jp.check(), tp.check()
    assert tr.ok == jr.ok is True
    assert tr.checked == jr.checked

    # peak live bytes: between the inputs plus the output and every op
    # output's bytes (the fake inputs are op outputs too: torch.empty)
    s = tplan.spec
    state = _state_bytes(tplan) if prepared else 4 * np.prod(k_shape)
    inputs = 4 * np.prod(x_shape) + state \
        + (4 * s.Cout if tplan.epilogue.bias else 0)
    assert tp.peak_live_bytes >= inputs + 4 * np.prod(tplan.out_shape)
    assert tp.peak_live_bytes <= outputs.total


def _state_bytes(plan) -> int:
    """Bytes of a prepared state on one rank of a (1, 1) mesh: the (P, C,
    C') planes of G, or the kernel itself for ``direct``."""
    if plan.backend == "direct":
        return 4 * np.prod(plan.k_shape)
    P = {"real": num_freq_real(plan.spec.delta),
         "complex": plan.spec.delta ** 2}[plan.spectrum]
    return 2 * 4 * P * plan.spec.C * plan.spec.Cout
