"""GeoDataFrame: a pandas DataFrame with a geometry column + CRS (the
port's copy of ``obia_tpu/vector/geodataframe.py``, trimmed to
construction and the GeoPackage writer).

This module imports pandas, which the card's machine need not have: the
port imports it only inside ``ObjectTable.to_geodataframe``, at the API
edge.
"""
from __future__ import annotations

from typing import Optional

import pandas as pd

from ..geometry.crs import CRS
from ..io import gpkg as gpkg_io


class GeoDataFrame(pd.DataFrame):
    _metadata = ["crs"]

    def __init__(self, data=None, *args, geometry=None, crs=None, columns=None,
                 **kwargs):
        if data is None and geometry is not None:
            data = {"geometry": list(geometry)}
            geometry = None
        super().__init__(data, *args, columns=columns, **kwargs)
        if geometry is not None:
            self["geometry"] = list(geometry)
        object.__setattr__(self, "crs", CRS.from_user_input(crs) if crs is not None else None)

    @property
    def _constructor(self):
        def _c(mgr, *args, **kwargs):
            # pandas internals hand us a BlockManager (no extra kwargs) OR
            # call the constructor like DataFrame(data, index=..., ...)
            # (transpose/dropna/reduction paths) — accept both
            if (not args and not kwargs and hasattr(mgr, "axes")
                    and not isinstance(mgr, pd.DataFrame)):
                # route through _from_mgr to avoid the deprecated
                # BlockManager __init__ path
                return GeoDataFrame._from_mgr(mgr, axes=mgr.axes)
            df = pd.DataFrame(mgr, *args, **kwargs)
            return GeoDataFrame._from_mgr(df._mgr, axes=df._mgr.axes)
        return _c

    # pandas copies lose __init__-set attrs; make crs default None not raise
    def __getattr__(self, name):
        if name == "crs":
            return None
        return super().__getattr__(name)

    # -- geometry access ------------------------------------------------------
    @property
    def geometry(self) -> pd.Series:
        return self["geometry"]

    # -- I/O ------------------------------------------------------------------
    def to_file(self, path: str, driver: Optional[str] = None,
                layer: Optional[str] = None) -> None:
        """Write a GeoPackage layer (the one output format the port has)."""
        if driver is None:
            driver = "GPKG"
        if driver != "GPKG":
            raise ValueError(f"only GPKG output is supported, got {driver}")
        if len(self) and any(g is None for g in self.geometry):
            raise ValueError(
                "GeoDataFrame has None geometries — refusing to write "
                "empty blobs")
        cols = [(c, self[c].tolist()) for c in self.columns if c != "geometry"]
        layer = layer or _layer_from_path(path)
        geom_types = {g.geom_type for g in self.geometry if g is not None}
        gtype = geom_types.pop() if len(geom_types) == 1 else "GEOMETRY"
        gpkg_io.write_gpkg(path, cols, list(self.geometry), layer=layer,
                           crs=self.crs, geometry_type=gtype.upper())


def _layer_from_path(path: str) -> str:
    import os
    return os.path.splitext(os.path.basename(path))[0] or "layer"
