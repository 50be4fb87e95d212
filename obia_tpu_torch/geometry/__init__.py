"""The port's geometry layer: the affine, the CRS, the polygon, line and
point types, ``affine_transform``, the WKB codec (``wkb``), the ring
grouping that the polygoniser and the GeoPackage writer use, and the
``intersects`` predicate of the label join."""
from .affine import Affine
from .crs import CRS
from .geom import (Geometry, LineString, MultiPolygon, Point, Polygon,
                   affine_transform, box)
from . import wkb

__all__ = ["Affine", "CRS", "Geometry", "LineString", "MultiPolygon", "Point",
           "Polygon", "affine_transform", "box", "wkb"]
