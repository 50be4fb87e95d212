"""The port's geometry layer: the affine, the CRS, the polygon and point
types, the ring grouping that the polygoniser and the GeoPackage writer use,
and the ``intersects`` predicate of the label join."""
from .affine import Affine
from .crs import CRS
from .geom import Geometry, MultiPolygon, Point, Polygon, box

__all__ = ["Affine", "CRS", "Geometry", "MultiPolygon", "Point", "Polygon",
           "box"]
