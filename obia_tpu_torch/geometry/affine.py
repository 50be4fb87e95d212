"""Affine transform for georeferencing (the port's copy of
``obia_tpu/geometry/affine.py``).

Self-contained replacement for the ``affine`` package used by the reference
(its ``handlers/geotif.py:91`` builds a 6-list in shapely
``affine_transform`` order ``[a, b, d, e, c, f]`` from a rasterio transform).

An ``Affine(a, b, c, d, e, f)`` maps pixel (col, row) to world (x, y):

    x = a * col + b * row + c
    y = d * col + e * row + f
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple


class Affine(tuple):
    """2-D affine transform, compatible with the ``affine.Affine`` API surface
    the reference relies on (``.a .. .f``, ``*`` composition and point
    application, ``~`` inversion, ``from_gdal``/``to_gdal``)."""

    __slots__ = ()

    def __new__(cls, a: float, b: float, c: float, d: float, e: float, f: float):
        return tuple.__new__(cls, (float(a), float(b), float(c),
                                   float(d), float(e), float(f)))

    def __getnewargs__(self):
        return tuple(self)  # pickle/deepcopy support

    # -- named members ------------------------------------------------------
    @property
    def a(self) -> float: return self[0]
    @property
    def b(self) -> float: return self[1]
    @property
    def c(self) -> float: return self[2]
    @property
    def d(self) -> float: return self[3]
    @property
    def e(self) -> float: return self[4]
    @property
    def f(self) -> float: return self[5]

    # -- constructors --------------------------------------------------------
    @classmethod
    def identity(cls) -> "Affine":
        return cls(1, 0, 0, 0, 1, 0)

    @classmethod
    def translation(cls, xoff: float, yoff: float) -> "Affine":
        return cls(1, 0, xoff, 0, 1, yoff)

    @classmethod
    def scale(cls, sx: float, sy: float | None = None) -> "Affine":
        if sy is None:
            sy = sx
        return cls(sx, 0, 0, 0, sy, 0)

    @classmethod
    def rotation(cls, angle_deg: float) -> "Affine":
        t = math.radians(angle_deg)
        ct, st = math.cos(t), math.sin(t)
        return cls(ct, -st, 0, st, ct, 0)

    @classmethod
    def from_gdal(cls, c: float, a: float, b: float, f: float, d: float, e: float) -> "Affine":
        """GDAL geotransform order (x0, dx, rx, y0, ry, dy)."""
        return cls(a, b, c, d, e, f)

    def to_gdal(self) -> Tuple[float, float, float, float, float, float]:
        return (self.c, self.a, self.b, self.f, self.d, self.e)

    # -- algebra ------------------------------------------------------------
    def __mul__(self, other):
        """Compose with another Affine, or apply to an (x, y) pair."""
        if isinstance(other, Affine):
            sa, sb, sc, sd, se, sf = self
            oa, ob, oc, od, oe, of = other
            return Affine(
                sa * oa + sb * od, sa * ob + sb * oe, sa * oc + sb * of + sc,
                sd * oa + se * od, sd * ob + se * oe, sd * oc + se * of + sf,
            )
        if isinstance(other, Iterable):
            x, y = other
            return (self.a * x + self.b * y + self.c,
                    self.d * x + self.e * y + self.f)
        return NotImplemented

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("Affine transform is not invertible")
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def __repr__(self) -> str:
        return (f"Affine({self.a!r}, {self.b!r}, {self.c!r},\n"
                f"       {self.d!r}, {self.e!r}, {self.f!r})")

    # -- helpers -------------------------------------------------------------
    @property
    def xoff(self) -> float: return self.c
    @property
    def yoff(self) -> float: return self.f

    def shapely_order(self) -> list:
        """6-list in shapely ``affine_transform`` order [a, b, d, e, c, f],
        the ``affine_transformation`` attribute the reference exposes
        (reference geotif.py:91)."""
        return [self.a, self.b, self.d, self.e, self.c, self.f]
