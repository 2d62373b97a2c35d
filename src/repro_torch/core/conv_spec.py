"""Convolution + overlap-save tiling specification."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static geometry of one FFT-based convolution.

    Overlap-save with tile ``delta x delta``: every tile of the padded input
    yields a ``t x t`` block of valid outputs, ``t = delta - k + 1``.
    """
    B: int
    C: int
    Cout: int
    H: int
    W: int
    kh: int
    kw: int
    pad_h: int = 0
    pad_w: int = 0
    delta: int = 16

    def __post_init__(self):
        if self.kh > self.delta or self.kw > self.delta:
            raise ValueError(
                f"kernel {self.kh}x{self.kw} exceeds tile size {self.delta}")

    # ---- derived geometry -------------------------------------------------
    @property
    def t_h(self) -> int:              # valid outputs per tile, rows
        return self.delta - self.kh + 1

    @property
    def t_w(self) -> int:
        return self.delta - self.kw + 1

    @property
    def Ho(self) -> int:
        return self.H + 2 * self.pad_h - self.kh + 1

    @property
    def Wo(self) -> int:
        return self.W + 2 * self.pad_w - self.kw + 1

    @property
    def X(self) -> int:                # tile grid rows
        return math.ceil(self.Ho / self.t_h)

    @property
    def D(self) -> int:                # tile grid cols (paper's Delta)
        return math.ceil(self.Wo / self.t_w)

    @property
    def n_tiles(self) -> int:
        return self.X * self.D

    @property
    def M(self) -> int:                # CGEMM row count: B * X * Delta
        return self.B * self.n_tiles

    @property
    def delta_h(self) -> int:          # rfft column count
        return self.delta // 2 + 1

    @property
    def P(self) -> int:                # stored complex frequency points
        return self.delta * self.delta_h

    # padded input extent covered by the tile grid (>= H + 2*pad)
    @property
    def Hp(self) -> int:
        return (self.X - 1) * self.t_h + self.delta

    @property
    def Wp(self) -> int:
        return (self.D - 1) * self.t_w + self.delta

    def freq_points(self, spectrum: str = "rect") -> int:
        """Stored frequency points for a spectrum layout (see
        ``repro_torch.core.fftconv``): the rect rfft2 grid (``P``), the compact
        Hermitian list (``"real"``), or the full spectrum (``"complex"``)."""
        if spectrum == "rect":
            return self.P
        if spectrum == "complex":
            return self.delta * self.delta
        if spectrum == "real":
            d = self.delta
            return d * d // 2 + 2 if d % 2 == 0 else (d * d + 1) // 2
        raise ValueError(f"unknown spectrum {spectrum!r}")

    # ---- cost model (for roofline / napkin math) --------------------------
    def direct_flops(self) -> int:
        return 2 * self.B * self.Cout * self.C * self.Ho * self.Wo * self.kh * self.kw

    def cgemm_flops(self, three_m: bool = False,
                    spectrum: str = "rect") -> int:
        per_point = (6 if three_m else 8) * self.M * self.C * self.Cout
        return self.freq_points(spectrum) * per_point

    def transform_flops(self) -> int:
        # input + kernel + inverse transforms, 6 small matmuls each ~2*d^3-ish
        d, dh = self.delta, self.delta_h
        per_tile = 2 * d * d * d * 2 + 4 * 2 * d * d * dh   # fwd: F@x (2) + A@Fh (4)
        inv_per_tile = 4 * 2 * d * d * dh + 2 * 2 * d * dh * d
        return (self.B * self.n_tiles * self.C + self.C * self.Cout) * per_tile \
            + self.B * self.n_tiles * self.Cout * inv_per_tile
