"""The port's geometry layer: the affine, the CRS, the polygon types and
the ring grouping that the polygoniser and the GeoPackage writer use."""
from .affine import Affine
from .crs import CRS
from .geom import Geometry, MultiPolygon, Polygon

__all__ = ["Affine", "CRS", "Geometry", "MultiPolygon", "Polygon"]
