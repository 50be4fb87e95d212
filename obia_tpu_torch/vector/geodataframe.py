"""GeoDataFrame: a pandas DataFrame with a geometry column + CRS (the
port's copy of ``obia_tpu/vector/geodataframe.py``, trimmed to
construction, ``total_bounds``, ``bounds``, ``to_crs``, the ``intersects``,
``within`` and ``overlaps`` predicates, the GeoPackage, GeoJSON and
shapefile writer and reader (:func:`read_file`, through the pandas-free
:mod:`.features`), and ``sjoin`` on ``intersects``, ``within`` or
``contains``, with which ``label_segments`` joins labelled points).

This module imports pandas, which the card's machine need not have: the
port imports it only inside ``ObjectTable.to_geodataframe``, at the API
edge.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..geometry.crs import CRS
from ..geometry.geom import Geometry
from . import features


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

    @property
    def total_bounds(self) -> np.ndarray:
        return features.Features({}, list(self.geometry)).total_bounds

    @property
    def bounds(self) -> pd.DataFrame:
        bs = [g.bounds if g is not None else (np.nan,) * 4
              for g in self.geometry]
        return pd.DataFrame(bs, columns=["minx", "miny", "maxx", "maxy"],
                            index=self.index)

    def to_crs(self, crs) -> "GeoDataFrame":
        """Reproject every geometry to ``crs``: WGS84 geographic, UTM
        326xx/327xx and Web Mercator; any other pair raises
        :class:`obia_tpu_torch.geometry.transform_crs.CRSTransformError`."""
        dst = CRS.from_user_input(crs)
        if self.crs is None:
            raise ValueError("to_crs: this GeoDataFrame has no source CRS")
        out = self.copy()
        out["geometry"] = features.reproject(list(self.geometry), self.crs,
                                             dst)
        object.__setattr__(out, "crs", dst)
        return out

    # -- predicates -----------------------------------------------------------
    def intersects(self, other: Geometry) -> pd.Series:
        ob = other.bounds
        out = []
        for g in self.geometry:
            if g is None:
                out.append(False)
                continue
            b = g.bounds
            if b[2] < ob[0] or ob[2] < b[0] or b[3] < ob[1] or ob[3] < b[1]:
                out.append(False)
            else:
                out.append(g.intersects(other))
        return pd.Series(out, index=self.index)

    def within(self, other: Geometry) -> pd.Series:
        return pd.Series([g.within(other) if g is not None else False
                          for g in self.geometry], index=self.index)

    def overlaps(self, other: Geometry) -> pd.Series:
        return pd.Series([g.overlaps(other) if g is not None else False
                          for g in self.geometry], index=self.index)

    # -- I/O ------------------------------------------------------------------
    def to_file(self, path: str, driver: Optional[str] = None,
                layer: Optional[str] = None) -> None:
        """Write a GeoPackage layer, a GeoJSON file or a shapefile, the
        format from ``driver`` or else the extension; a None geometry
        raises."""
        cols = [(c, self[c].tolist()) for c in self.columns if c != "geometry"]
        features.write_features(path, cols, list(self.geometry), self.crs,
                                driver=driver, layer=layer)


def read_file(path: str, layer: Optional[str] = None,
              bbox=None) -> GeoDataFrame:
    """Read a GeoPackage layer, a GeoJSON file or a shapefile (the format
    from the extension); ``bbox`` keeps rows without a geometry."""
    t = features.read_features(path, layer=layer, bbox=bbox)
    gdf = GeoDataFrame(t.columns if t.columns else None,
                       geometry=t.geometry, crs=t.crs)
    if "geometry" not in gdf.columns:
        gdf["geometry"] = t.geometry
    return gdf


# --- spatial join -------------------------------------------------------------

def sjoin(left: GeoDataFrame, right: GeoDataFrame, how: str = "inner",
          predicate: str = "intersects",
          lsuffix: str = "left", rsuffix: str = "right") -> GeoDataFrame:
    """Inner spatial join, geopandas-shaped: one row per (left, right) pair
    for which ``predicate`` (``intersects``, ``within`` or ``contains``)
    holds, in :func:`.features.join_pairs`' order, the left index kept, the
    right row's index in ``index_right``, and colliding column names
    suffixed on both sides."""
    if how != "inner":
        raise NotImplementedError("only how='inner' is supported")
    pairs = features.join_pairs(list(left.geometry), list(right.geometry),
                                predicate)

    if not pairs:
        out = GeoDataFrame(columns=list(left.columns)
                           + [c for c in right.columns if c != "geometry"]
                           + ["index_right"])
        object.__setattr__(out, "crs", left.crs)
        return out

    lpos = [p[0] for p in pairs]
    rpos = [p[1] for p in pairs]
    lpart = left.iloc[lpos].copy()
    rpart = right.drop(columns=["geometry"], errors="ignore").iloc[rpos]

    # geopandas collision semantics: BOTH sides get suffixed
    collide = {c for c in rpart.columns
               if c in lpart.columns and c != "geometry"}
    data = {}
    for c in lpart.columns:
        name = f"{c}_{lsuffix}" if c in collide else c
        data[name] = (lpart[c].to_numpy(dtype=object) if c != "geometry"
                      else list(lpart[c]))
    for c in rpart.columns:
        name = f"{c}_{rsuffix}" if c in collide else c
        data[name] = rpart[c].to_numpy(dtype=object)
    data["index_right"] = right.index.to_numpy()[rpos]

    out = GeoDataFrame(data)
    out.index = left.index.take(lpos)
    object.__setattr__(out, "crs", left.crs)
    return out
