"""Minimal coordinate-reference-system handling (the port's copy of
``obia_tpu/geometry/crs.py``).

The reference delegates CRS work to pyproj/rasterio (reference
segment_boundaries.py:74-76 does ``pyproj.CRS(image.crs).to_epsg()``); this
framework stores the EPSG code directly and synthesises WKT for the GeoPackage
``gpkg_spatial_ref_sys`` table. No reprojection is needed anywhere in the
reference API, so none is provided here.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

_WGS84_GEOGCS = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
    '298.257223563,AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]]'
)


def _utm_wkt(zone: int, north: bool) -> str:
    epsg = (32600 if north else 32700) + zone
    lon0 = -183 + 6 * zone
    hemi = "N" if north else "S"
    fn = 0 if north else 10000000
    return (
        f'PROJCS["WGS 84 / UTM zone {zone}{hemi}",{_WGS84_GEOGCS},'
        f'PROJECTION["Transverse_Mercator"],'
        f'PARAMETER["latitude_of_origin",0],'
        f'PARAMETER["central_meridian",{lon0}],'
        f'PARAMETER["scale_factor",0.9996],'
        f'PARAMETER["false_easting",500000],'
        f'PARAMETER["false_northing",{fn}],'
        f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
        f'AUTHORITY["EPSG","{epsg}"]]'
    )


_KNOWN_WKT = {
    4326: _WGS84_GEOGCS,
    3857: (
        'PROJCS["WGS 84 / Pseudo-Mercator",' + _WGS84_GEOGCS + ','
        'PROJECTION["Mercator_1SP"],PARAMETER["central_meridian",0],'
        'PARAMETER["scale_factor",1],PARAMETER["false_easting",0],'
        'PARAMETER["false_northing",0],UNIT["metre",1,'
        'AUTHORITY["EPSG","9001"]],AXIS["Easting",EAST],'
        'AXIS["Northing",NORTH],AUTHORITY["EPSG","3857"]]'
    ),
}


# EPSG codes that break the "4000-4999 = geographic" range heuristic:
# projected systems registered inside the range...
_PROJECTED_IN_4XXX = frozenset({
    4087,  # WGS 84 / World Equidistant Cylindrical
    4088,  # World Equidistant Cylindrical (Sphere)
    4467,  # RGSPM06 / UTM zone 21N
    4471,  # RGM04 / UTM zone 38S
    4647,  # ETRS89 / UTM zone 32N (zE-N)
    4839,  # ETRS89 / LCC Germany (N-E)
})
# ...and geographic 2D systems registered outside it
_GEOGRAPHIC_OUTSIDE_4XXX = frozenset({
    3819,  # HD1909
    3821,  # TWD67
    3824,  # TWD97
    3889,  # IGRS
    3906,  # MGI 1901
})


class CRS:
    """A CRS identified by EPSG code (optionally carrying verbatim WKT)."""

    __slots__ = ("_epsg", "_wkt")

    def __init__(self, epsg: Optional[int] = None, wkt: Optional[str] = None):
        self._epsg = int(epsg) if epsg is not None else None
        self._wkt = wkt

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_epsg(cls, code: int) -> "CRS":
        return cls(epsg=int(code))

    @classmethod
    def from_wkt(cls, wkt: str) -> "CRS":
        epsg = _epsg_from_wkt(wkt)
        return cls(epsg=epsg, wkt=wkt)

    @classmethod
    def from_user_input(cls, value: Union["CRS", int, str, None]) -> Optional["CRS"]:
        if value is None:
            return None
        if isinstance(value, CRS):
            return value
        if isinstance(value, (int, np.integer)):
            return cls.from_epsg(int(value))
        if isinstance(value, str):
            v = value.strip()
            if v.upper().startswith("EPSG:"):
                return cls.from_epsg(int(v.split(":", 1)[1]))
            if v.isdigit():
                return cls.from_epsg(int(v))
            return cls.from_wkt(v)
        if isinstance(value, dict) and "init" in value:  # proj4-style dict
            init = value["init"]
            if init.lower().startswith("epsg:"):
                return cls.from_epsg(int(init.split(":", 1)[1]))
        raise ValueError(f"Cannot interpret CRS from {value!r}")

    # -- accessors -----------------------------------------------------------
    def to_epsg(self) -> Optional[int]:
        return self._epsg

    @property
    def is_geographic(self) -> bool:
        """True for lat/lon (geographic 2D) systems. The WKT root keyword
        is authoritative when present; bare EPSG codes fall back to the
        4xxx-range heuristic with known real-world exceptions on both
        sides (the EPSG registry sprinkles projected systems into
        4000-4999 and geographic ones outside it)."""
        if self._wkt:
            head = self._wkt.lstrip().upper()
            if head.startswith(("GEOGCS", "GEOGCRS")):
                return True
            if head.startswith(("PROJCS", "PROJCRS")):
                return False
        e = self._epsg
        if e is None:
            return False
        if e in _PROJECTED_IN_4XXX:
            return False
        if e in _GEOGRAPHIC_OUTSIDE_4XXX:
            return True
        return e == 4326 or 4000 <= e < 5000

    def to_wkt(self) -> str:
        if self._wkt:
            return self._wkt
        e = self._epsg
        if e is None:
            return "undefined"
        if e in _KNOWN_WKT:
            return _KNOWN_WKT[e]
        if 32601 <= e <= 32660:
            return _utm_wkt(e - 32600, north=True)
        if 32701 <= e <= 32760:
            return _utm_wkt(e - 32700, north=False)
        # Generic stub keeping the authority code round-trippable.
        return (f'PROJCS["EPSG:{e}",{_WGS84_GEOGCS},'
                f'UNIT["metre",1],AUTHORITY["EPSG","{e}"]]')

    def __eq__(self, other) -> bool:
        if not isinstance(other, CRS):
            try:
                other = CRS.from_user_input(other)
            except Exception:
                # equality must never raise (membership tests, pandas
                # comparisons): an uncoercible operand is just unequal
                return NotImplemented
        if other is None:
            return False
        return self._epsg == other._epsg

    def __hash__(self):
        return hash(self._epsg)

    def __repr__(self) -> str:
        return f"CRS(EPSG:{self._epsg})" if self._epsg else "CRS(undefined)"

    def __str__(self) -> str:
        return f"EPSG:{self._epsg}" if self._epsg else "undefined"


def _epsg_from_wkt(wkt: str) -> Optional[int]:
    """Extract the outermost AUTHORITY EPSG code (last occurrence = outer
    object in WKT1 ordering)."""
    import re
    matches = re.findall(r'AUTHORITY\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
    if matches:
        return int(matches[-1])
    m = re.search(r'ID\[\s*"EPSG"\s*,\s*(\d+)\s*\]', wkt)  # WKT2
    return int(m.group(1)) if m else None
