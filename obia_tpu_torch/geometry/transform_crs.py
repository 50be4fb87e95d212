"""Coordinate reprojection without PROJ (the port's copy of
``obia_tpu/geometry/transform_crs.py``): WGS84 geographic <-> UTM
(transverse Mercator, Krueger 6th-order series) <-> Web Mercator.

Vectors are reprojected to the raster CRS before use, as the reference's
``gdf.to_crs(src.crs)`` does (reference utils/cost.py:63). The supported
pairs are the ones this domain uses (WGS84/UTM scenes, EPSG:3857 web tiles,
EPSG:4326 field points), with sub-centimetre round trips at UTM-zone scale;
anything else raises :class:`CRSTransformError` rather than silently
mis-registering.

Math: Karney, "Transverse Mercator with an accuracy of a few nanometers"
(J. Geod. 85, 2011), the Krueger series in the third flattening n to 6th
order. Every function is vectorised float64 numpy on the host.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .crs import CRS

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_E = np.sqrt(_E2)
_N = _F / (2.0 - _F)  # third flattening

# rectifying radius A = a/(1+n) (1 + n^2/4 + n^4/64 + n^6/256)
_RECT_A = _A / (1.0 + _N) * (1.0 + _N ** 2 / 4 + _N ** 4 / 64
                             + _N ** 6 / 256)

_n = _N
_ALPHA = (
    _n / 2 - 2 * _n ** 2 / 3 + 5 * _n ** 3 / 16 + 41 * _n ** 4 / 180
    - 127 * _n ** 5 / 288 + 7891 * _n ** 6 / 37800,
    13 * _n ** 2 / 48 - 3 * _n ** 3 / 5 + 557 * _n ** 4 / 1440
    + 281 * _n ** 5 / 630 - 1983433 * _n ** 6 / 1935360,
    61 * _n ** 3 / 240 - 103 * _n ** 4 / 140 + 15061 * _n ** 5 / 26880
    + 167603 * _n ** 6 / 181440,
    49561 * _n ** 4 / 161280 - 179 * _n ** 5 / 168
    + 6601661 * _n ** 6 / 7257600,
    34729 * _n ** 5 / 80640 - 3418889 * _n ** 6 / 1995840,
    212378941 * _n ** 6 / 149504000,
)
_BETA = (
    _n / 2 - 2 * _n ** 2 / 3 + 37 * _n ** 3 / 96 - _n ** 4 / 360
    - 81 * _n ** 5 / 512 + 96199 * _n ** 6 / 604800,
    _n ** 2 / 48 + _n ** 3 / 15 - 437 * _n ** 4 / 1440 + 46 * _n ** 5 / 105
    - 1118711 * _n ** 6 / 3870720,
    17 * _n ** 3 / 480 - 37 * _n ** 4 / 840 - 209 * _n ** 5 / 4480
    + 5569 * _n ** 6 / 90720,
    4397 * _n ** 4 / 161280 - 11 * _n ** 5 / 504
    - 830251 * _n ** 6 / 7257600,
    4583 * _n ** 5 / 161280 - 108847 * _n ** 6 / 3991680,
    20648693 * _n ** 6 / 638668800,
)
# conformal latitude chi -> geodetic phi series
_DELTA = (
    2 * _n - 2 * _n ** 2 / 3 - 2 * _n ** 3 + 116 * _n ** 4 / 45
    + 26 * _n ** 5 / 45 - 2854 * _n ** 6 / 675,
    7 * _n ** 2 / 3 - 8 * _n ** 3 / 5 - 227 * _n ** 4 / 45
    + 2704 * _n ** 5 / 315 + 2323 * _n ** 6 / 945,
    56 * _n ** 3 / 15 - 136 * _n ** 4 / 35 - 1262 * _n ** 5 / 105
    + 73814 * _n ** 6 / 2835,
    4279 * _n ** 4 / 630 - 332 * _n ** 5 / 35 - 399572 * _n ** 6 / 14175,
    4174 * _n ** 5 / 315 - 144838 * _n ** 6 / 6237,
    601676 * _n ** 6 / 22275,
)

_K0_UTM = 0.9996
_FE_UTM = 500000.0
_FN_SOUTH = 10000000.0


class CRSTransformError(ValueError):
    """Raised for CRS pairs this module cannot transform exactly."""


def _tm_forward(lon_deg, lat_deg, lon0_deg: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Geographic (deg) -> unscaled transverse Mercator (xi, eta)."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlon = np.radians(np.asarray(lon_deg, dtype=np.float64) - lon0_deg)
    s = np.sin(lat)
    # conformal latitude via tangent: t = sinh(asinh(tan) - e atanh(e sin))
    t = np.sinh(np.arcsinh(np.tan(lat)) - _E * np.arctanh(_E * s))
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arcsinh(np.sin(dlon) / np.hypot(t, np.cos(dlon)))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, a in enumerate(_ALPHA, start=1):
        xi += a * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta += a * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
    return xi, eta


def _tm_inverse(xi, eta, lon0_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Unscaled transverse Mercator (xi, eta) -> geographic (deg)."""
    xi = np.asarray(xi, dtype=np.float64)
    eta = np.asarray(eta, dtype=np.float64)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b in enumerate(_BETA, start=1):
        xi_p -= b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p -= b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    # conformal latitude and longitude offset
    chi = np.arctan2(np.sin(xi_p), np.hypot(np.sinh(eta_p), np.cos(xi_p)))
    dlon = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    phi = chi.copy()
    for j, d in enumerate(_DELTA, start=1):
        phi += d * np.sin(2 * j * chi)
    return np.degrees(dlon) + lon0_deg, np.degrees(phi)


def utm_forward(lon, lat, zone: int, north: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
    lon0 = zone * 6.0 - 183.0
    xi, eta = _tm_forward(lon, lat, lon0)
    E = _FE_UTM + _K0_UTM * _RECT_A * eta
    Nn = _K0_UTM * _RECT_A * xi + (0.0 if north else _FN_SOUTH)
    return E, Nn


def utm_inverse(E, Nn, zone: int, north: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
    lon0 = zone * 6.0 - 183.0
    E = np.asarray(E, dtype=np.float64)
    Nn = np.asarray(Nn, dtype=np.float64)
    xi = (Nn - (0.0 if north else _FN_SOUTH)) / (_K0_UTM * _RECT_A)
    eta = (E - _FE_UTM) / (_K0_UTM * _RECT_A)
    return _tm_inverse(xi, eta, lon0)


def webmercator_forward(lon, lat) -> Tuple[np.ndarray, np.ndarray]:
    """EPSG:3857 (spherical formulas on the WGS84 semi-major, per the
    EPSG 'Popular Visualisation Pseudo Mercator' method 1024)."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    x = _A * np.radians(lon)
    y = _A * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2))
    return x, y


def webmercator_inverse(x, y) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lon = np.degrees(x / _A)
    lat = np.degrees(2 * np.arctan(np.exp(y / _A)) - np.pi / 2)
    return lon, lat


def _crs_kind(crs: CRS):
    """('geographic',) | ('utm', zone, north) | ('webmerc',) or None."""
    e = crs.to_epsg()
    if e is None:
        return None
    if e == 4326:
        return ("geographic",)
    if 32601 <= e <= 32660:
        return ("utm", e - 32600, True)
    if 32701 <= e <= 32760:
        return ("utm", e - 32700, False)
    if e in (3857, 900913, 3785):
        return ("webmerc",)
    return None


class Transformer:
    """pyproj-shaped coordinate transformer between the supported CRS.

    >>> tr = Transformer.from_crs(4326, 32633, always_xy=True)
    >>> x, y = tr.transform(15.0, 0.0)   # -> (500000, 0)
    """

    def __init__(self, src: CRS, dst: CRS):
        self.src = src
        self.dst = dst
        self._skind = _crs_kind(src)
        self._dkind = _crs_kind(dst)
        if self._skind is None or self._dkind is None:
            bad = src if self._skind is None else dst
            raise CRSTransformError(
                f"unsupported CRS for coordinate transformation: {bad} "
                "(supported: EPSG:4326, UTM 326xx/327xx, EPSG:3857). "
                "Reproject externally or supply data in the raster CRS.")

    @classmethod
    def from_crs(cls, src, dst, always_xy: bool = True) -> "Transformer":
        if not always_xy:
            raise CRSTransformError(
                "axis-order games are not implemented: pass always_xy=True "
                "(x=lon/easting, y=lat/northing)")
        return cls(CRS.from_user_input(src), CRS.from_user_input(dst))

    def transform(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        scalar = np.isscalar(x) and np.isscalar(y)
        if self.src == self.dst:
            out = np.asarray(x, np.float64), np.asarray(y, np.float64)
        else:
            # pivot through geographic
            sk, dk = self._skind, self._dkind
            if sk[0] == "geographic":
                lon, lat = np.asarray(x, np.float64), np.asarray(y, np.float64)
            elif sk[0] == "utm":
                lon, lat = utm_inverse(x, y, sk[1], sk[2])
            else:
                lon, lat = webmercator_inverse(x, y)
            if dk[0] == "geographic":
                out = lon, lat
            elif dk[0] == "utm":
                out = utm_forward(lon, lat, dk[1], dk[2])
            else:
                out = webmercator_forward(lon, lat)
        if scalar:
            return float(out[0]), float(out[1])
        return out


def transform_geom(geom, transformer: Transformer):
    """Apply a Transformer to every coordinate of a geometry."""
    from .geom import LineString, MultiPolygon, Point, Polygon

    def tx(coords: np.ndarray) -> np.ndarray:
        x, y = transformer.transform(coords[:, 0], coords[:, 1])
        return np.stack([x, y], axis=1)

    if isinstance(geom, Point):
        x, y = transformer.transform(geom.x, geom.y)
        return Point(x, y)
    if isinstance(geom, LineString):
        return LineString(tx(geom.coords_array))
    if isinstance(geom, Polygon):
        return Polygon(tx(geom.exterior.coords_array),
                       [tx(h.coords_array) for h in geom.interiors])
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([transform_geom(g, transformer)
                             for g in geom.geoms])
    raise TypeError(f"cannot transform {type(geom)}")


def to_raster_crs(gdf, raster_crs: Union[CRS, int, str, None]):
    """Reproject a table (anything with ``crs`` and ``to_crs``: a
    ``GeoDataFrame`` or a pandas-free :class:`obia_tpu_torch.vector.
    features.Features`) to the raster CRS if they differ, where the
    reference calls ``gdf.to_crs`` (reference cost.py:63). Same-CRS and
    missing-CRS inputs pass through untouched; an unsupported pair raises
    instead of mis-registering."""
    raster_crs = CRS.from_user_input(raster_crs)
    if raster_crs is None or getattr(gdf, "crs", None) is None:
        return gdf
    if gdf.crs == raster_crs:
        return gdf
    return gdf.to_crs(raster_crs)
