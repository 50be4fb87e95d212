"""Numpy-backed planar geometry types (the port's copy of
``obia_tpu/geometry/geom.py``, trimmed to what the port uses).

The polygoniser builds a :class:`Polygon` per ring group (holes assigned by
point-in-polygon) or a :class:`MultiPolygon` for a region pinched at a
corner; the GeoPackage writer reads ``bounds``, ``is_empty`` and
``geom_type``, and callers read ``area`` and ``centroid``. The GeoJSON and
shapefile codecs and the CRS transforms also carry :class:`LineString`s,
which ``within``, ``contains`` and ``overlaps`` take as paths and
``intersects`` does not take. Labelled points (:class:`Point`) and
``intersects`` serve ``label_segments`` and the acceptable-classes mask of
``classify``; ``within``, ``contains`` and ``overlaps`` (shapely's
semantics) serve the tiled segmentation and ``sjoin``, and
:func:`affine_transform` the rasteriser. Coordinates are float64 numpy
arrays.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Geometry:
    """Base class. Subclasses: Point, LineString, Polygon, MultiPolygon."""

    geom_type = "Geometry"

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        raise NotImplementedError

    @property
    def is_empty(self) -> bool:
        return False

    def intersects(self, other: "Geometry") -> bool:
        if not _bbox_overlap(self.bounds, other.bounds):
            return False
        return _intersects(self, other)

    def within(self, other: "Geometry") -> bool:
        sb, ob = self.bounds, other.bounds
        # bbox fast-reject: must be fully inside the candidate's bbox
        if sb[0] < ob[0] or sb[1] < ob[1] or sb[2] > ob[2] or sb[3] > ob[3]:
            return False
        return _within(self, other)

    def contains(self, other: "Geometry") -> bool:
        return _within(other, self)

    def overlaps(self, other: "Geometry") -> bool:
        # shapely semantics: interiors intersect but neither contains the
        # other. Interior intersection = a proper boundary crossing, or a
        # vertex/edge-midpoint of one STRICTLY inside the other (boundary
        # touch alone — abutting tile/segment polygons — is NOT overlap)
        if self.within(other) or other.within(self):
            return False
        if _proper_boundary_crossing(self, other):
            return True
        return (_any_point_strictly_inside(self, other)
                or _any_point_strictly_inside(other, self))

    def buffer0(self) -> "Geometry":
        """The geometry itself, as the JAX package's stand-in for shapely's
        ``buffer(0)`` returns it: nothing is repaired."""
        return self

    def __repr__(self):
        b = self.bounds
        return f"<{self.geom_type} bounds=({b[0]:.3f}, {b[1]:.3f}, {b[2]:.3f}, {b[3]:.3f})>"


class Point(Geometry):
    geom_type = "Point"
    __slots__ = ("x", "y")

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)

    @property
    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    @property
    def coords(self):
        return [(self.x, self.y)]

    @property
    def centroid(self) -> "Point":
        return self

    @property
    def area(self) -> float:
        return 0.0


class LineString(Geometry):
    geom_type = "LineString"
    __slots__ = ("coords_array",)

    def __init__(self, coords):
        self.coords_array = np.asarray(coords, dtype=np.float64).reshape(-1, 2)

    @property
    def coords(self):
        return [tuple(c) for c in self.coords_array]

    @property
    def bounds(self):
        c = self.coords_array
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def length(self) -> float:
        d = np.diff(self.coords_array, axis=0)
        return float(np.hypot(d[:, 0], d[:, 1]).sum())

    @property
    def area(self) -> float:
        return 0.0


class _Ring:
    """Closed ring of coordinates (first == last)."""
    __slots__ = ("coords_array",)

    def __init__(self, coords):
        arr = np.asarray(coords, dtype=np.float64)
        if arr.ndim != 2:
            arr = arr.reshape(-1, 2)
        n = len(arr)
        # scalar item() closure check: ~5x cheaper than np.array_equal on
        # row views — rings are built in 50k+ batches by the polygonizer
        if n and (arr.item(0) != arr.item(2 * n - 2)
                  or arr.item(1) != arr.item(2 * n - 1)):
            arr = np.vstack([arr, arr[:1]])
        self.coords_array = arr

    @property
    def coords(self):
        return [tuple(c) for c in self.coords_array]

    def signed_area(self) -> float:
        c = self.coords_array
        if len(c) < 4:
            return 0.0
        x, y = c[:-1, 0], c[:-1, 1]
        x2, y2 = c[1:, 0], c[1:, 1]
        return float(0.5 * np.sum(x * y2 - x2 * y))


class Polygon(Geometry):
    geom_type = "Polygon"
    __slots__ = ("_shell", "_holes")

    def __init__(self, shell=None, holes: Optional[Sequence] = None):
        self._shell = _Ring(shell if shell is not None else np.zeros((0, 2)))
        self._holes = [_Ring(h) for h in (holes or [])]

    @property
    def exterior(self) -> _Ring:
        return self._shell

    @property
    def interiors(self) -> List[_Ring]:
        return self._holes

    @property
    def is_empty(self) -> bool:
        return len(self._shell.coords_array) == 0

    @property
    def bounds(self):
        c = self._shell.coords_array
        if len(c) == 0:
            return (np.nan,) * 4
        return (float(c[:, 0].min()), float(c[:, 1].min()),
                float(c[:, 0].max()), float(c[:, 1].max()))

    @property
    def area(self) -> float:
        a = abs(self._shell.signed_area())
        for h in self._holes:
            a -= abs(h.signed_area())
        return a

    @property
    def centroid(self) -> Point:
        # area-weighted centroid of shell minus holes
        def ring_cx_cy_a(ring: _Ring):
            c = ring.coords_array
            if len(c) < 4:
                return 0.0, 0.0, 0.0
            x, y = c[:-1, 0], c[:-1, 1]
            x2, y2 = c[1:, 0], c[1:, 1]
            cross = x * y2 - x2 * y
            a = cross.sum() / 2.0
            if a == 0:
                return float(x.mean()), float(y.mean()), 0.0
            cx = float(((x + x2) * cross).sum() / (6 * a))
            cy = float(((y + y2) * cross).sum() / (6 * a))
            return cx, cy, a
        cx, cy, a = ring_cx_cy_a(self._shell)
        num_x, num_y, denom = cx * abs(a), cy * abs(a), abs(a)
        for h in self._holes:
            hx, hy, ha = ring_cx_cy_a(h)
            num_x -= hx * abs(ha)
            num_y -= hy * abs(ha)
            denom -= abs(ha)
        if denom == 0:
            c = self._shell.coords_array
            return Point(float(c[:, 0].mean()), float(c[:, 1].mean()))
        return Point(num_x / denom, num_y / denom)

    def contains_points(self, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """Vectorised point-in-polygon (crossing number, boundary counts in)."""
        inside = _points_in_ring(self._shell.coords_array, xs, ys)
        for h in self._holes:
            inside &= ~_points_in_ring(h.coords_array, xs, ys, strict=True)
        return inside

    def difference_bbox(self, other_bounds) -> "Polygon":
        """The polygon itself, unchanged: the JAX package's placeholder,
        kept for its name; no bounding box is subtracted."""
        return self


class MultiPolygon(Geometry):
    geom_type = "MultiPolygon"
    __slots__ = ("geoms",)

    def __init__(self, polygons: Iterable[Polygon]):
        self.geoms = [p for p in polygons if not p.is_empty]

    @property
    def is_empty(self) -> bool:
        return len(self.geoms) == 0

    @property
    def bounds(self):
        if not self.geoms:
            return (np.nan,) * 4  # mirror Polygon's empty-geometry bounds
        bs = np.array([g.bounds for g in self.geoms])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))

    @property
    def area(self) -> float:
        return sum(g.area for g in self.geoms)

    @property
    def centroid(self) -> Point:
        areas = np.array([max(g.area, 1e-300) for g in self.geoms])
        cs = np.array([[g.centroid.x, g.centroid.y] for g in self.geoms])
        w = areas / areas.sum()
        return Point(float((cs[:, 0] * w).sum()), float((cs[:, 1] * w).sum()))

    def contains_points(self, xs, ys) -> np.ndarray:
        out = np.zeros(np.shape(xs), dtype=bool)
        for g in self.geoms:
            out |= g.contains_points(xs, ys)
        return out


def box(minx: float, miny: float, maxx: float, maxy: float) -> Polygon:
    return Polygon([(minx, miny), (maxx, miny), (maxx, maxy), (minx, maxy),
                    (minx, miny)])


def affine_transform_coords(coords: np.ndarray,
                            matrix: Sequence[float]) -> np.ndarray:
    """Shapely-order affine applied to an (N, 2) coordinate array — used
    standalone on the polygonizer's PACKED coords so one vectorised pass
    transforms every ring of a scene at once."""
    a, b, d, e, xoff, yoff = matrix
    x, y = coords[:, 0], coords[:, 1]
    return np.stack([a * x + b * y + xoff, d * x + e * y + yoff], axis=1)


def affine_transform(geom: Geometry, matrix: Sequence[float]) -> Geometry:
    """Shapely-order affine transform: matrix = [a, b, d, e, xoff, yoff];
    x' = a*x + b*y + xoff ; y' = d*x + e*y + yoff."""
    def tx(coords: np.ndarray) -> np.ndarray:
        return affine_transform_coords(coords, matrix)

    if isinstance(geom, Point):
        x, y = tx(np.array([[geom.x, geom.y]]))[0]
        return Point(x, y)
    if isinstance(geom, LineString):
        return LineString(tx(geom.coords_array))
    if isinstance(geom, Polygon):
        return Polygon(tx(geom.exterior.coords_array),
                       [tx(h.coords_array) for h in geom.interiors])
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([affine_transform(g, matrix) for g in geom.geoms])
    raise TypeError(f"cannot transform {type(geom)}")


# --- predicates -----------------------------------------------------------------

def _bbox_overlap(b1, b2) -> bool:
    return not (b1[2] < b2[0] or b2[2] < b1[0] or b1[3] < b2[1] or b2[3] < b1[1])


def _points_in_ring(ring: np.ndarray, xs, ys, strict: bool = False) -> np.ndarray:
    """Crossing-number test; points exactly on an edge count as inside
    (non-strict) which matches how segment polygons tile the plane."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    scalar = xs.ndim == 0
    xs = np.atleast_1d(xs)
    ys = np.atleast_1d(ys)
    n = len(ring) - 1
    inside = np.zeros(xs.shape, dtype=bool)
    if n < 3:
        return inside if not scalar else inside[0]
    x1, y1 = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    for i in range(n):
        yi, yj, xi, xj = y1[i], y2[i], x1[i], x2[i]
        cond = ((yi > ys) != (yj > ys))
        if not cond.any():
            continue
        xint = (xj - xi) * (ys - yi) / (yj - yi + 1e-300) + xi
        inside ^= cond & (xs < xint)
    # boundary handling: include points on edges for non-strict
    if not strict:
        on_edge = _points_on_ring_edges(ring, xs, ys)
        inside |= on_edge
    return inside[0] if scalar else inside


def _points_on_ring_edges(ring: np.ndarray, xs, ys, tol: float = 1e-9) -> np.ndarray:
    out = np.zeros(xs.shape, dtype=bool)
    x1, y1 = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    for i in range(len(ring) - 1):
        dx, dy = x2[i] - x1[i], y2[i] - y1[i]
        cross = (xs - x1[i]) * dy - (ys - y1[i]) * dx
        seg_len2 = dx * dx + dy * dy
        if seg_len2 == 0:
            near = (np.abs(xs - x1[i]) < tol) & (np.abs(ys - y1[i]) < tol)
        else:
            t = ((xs - x1[i]) * dx + (ys - y1[i]) * dy) / seg_len2
            near = (np.abs(cross) < tol * np.sqrt(seg_len2)) & (t >= -tol) & (t <= 1 + tol)
        out |= near
    return out


def _segments_intersect(p1, p2, p3, p4) -> bool:
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)
    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True

    def on_seg(a, b, c):
        return (min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12 and
                min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12)
    if o1 == 0 and on_seg(p1, p2, p3):
        return True
    if o2 == 0 and on_seg(p1, p2, p4):
        return True
    if o3 == 0 and on_seg(p3, p4, p1):
        return True
    if o4 == 0 and on_seg(p3, p4, p2):
        return True
    return False


def _rings_of(geom: Geometry) -> List[np.ndarray]:
    """The polygon rings of ``geom`` with at least 2 points (empty
    geometries have no boundary)."""
    if isinstance(geom, Polygon):
        rings = [geom.exterior.coords_array] + [h.coords_array
                                                for h in geom.interiors]
    elif isinstance(geom, MultiPolygon):
        rings = [r for g in geom.geoms for r in _rings_of(g)]
    else:
        rings = []
    return [r for r in rings if len(r) >= 2]


def _paths_of(geom: Geometry) -> List[np.ndarray]:
    """The boundary paths of ``within``, ``contains`` and ``overlaps``:
    :func:`_rings_of`, or a LineString's own path of at least 2 points."""
    if isinstance(geom, LineString):
        return [p for p in [geom.coords_array] if len(p) >= 2]
    return _rings_of(geom)


def _boundary_intersects(g1: Geometry, g2: Geometry) -> bool:
    for r1 in _rings_of(g1):
        for r2 in _rings_of(g2):
            # bbox prune per ring
            if not _bbox_overlap((r1[:, 0].min(), r1[:, 1].min(), r1[:, 0].max(), r1[:, 1].max()),
                                 (r2[:, 0].min(), r2[:, 1].min(), r2[:, 0].max(), r2[:, 1].max())):
                continue
            for i in range(len(r1) - 1):
                for j in range(len(r2) - 1):
                    if _segments_intersect(r1[i], r1[i + 1], r2[j], r2[j + 1]):
                        return True
    return False


def _first_vertex(g: Geometry):
    rings = _rings_of(g)
    if not rings or len(rings[0]) == 0:
        return None
    return rings[0][0]


def _intersects(g1: Geometry, g2: Geometry) -> bool:
    if isinstance(g1, Point):
        if isinstance(g2, Point):
            return abs(g1.x - g2.x) < 1e-12 and abs(g1.y - g2.y) < 1e-12
        g1, g2 = g2, g1
    polygonal = (Polygon, MultiPolygon)
    if isinstance(g2, Point) and isinstance(g1, polygonal):
        return bool(g1.contains_points(np.array(g2.x), np.array(g2.y)))
    if isinstance(g1, polygonal) and isinstance(g2, polygonal):
        # vertex containment either way, else boundary crossing
        v2 = _first_vertex(g2)
        if v2 is not None and g1.contains_points(np.array(v2[0]), np.array(v2[1])):
            return True
        v1 = _first_vertex(g1)
        if v1 is not None and g2.contains_points(np.array(v1[0]), np.array(v1[1])):
            return True
        return _boundary_intersects(g1, g2)
    raise TypeError(f"intersects not implemented for {type(g1)}/{type(g2)}")


def _any_point_strictly_inside(g: Geometry, container: Geometry) -> bool:
    """Any vertex or edge midpoint of ``g`` strictly inside ``container``
    (midpoints catch rectilinear overlaps whose vertices all sit on the
    container's boundary)."""
    if not isinstance(container, (Polygon, MultiPolygon)):
        return False
    for path in _paths_of(g):
        mid = (path[:-1] + path[1:]) * 0.5
        xs = np.concatenate([path[:, 0], mid[:, 0]])
        ys = np.concatenate([path[:, 1], mid[:, 1]])
        if _contains_points_strict(container, xs, ys).any():
            return True
    return False


def _contains_points_strict(geom: Geometry, xs, ys) -> np.ndarray:
    """Point-in-polygon with boundary EXCLUDED (interior membership)."""
    if isinstance(geom, MultiPolygon):
        out = np.zeros(np.shape(xs), dtype=bool)
        for g in geom.geoms:
            out |= _contains_points_strict(g, xs, ys)
        return out
    if not isinstance(geom, Polygon) or geom.is_empty:
        return np.zeros(np.shape(xs), dtype=bool)
    # the raw crossing-number parity is ambiguous for points exactly ON
    # an edge (it counts crossings to one side only) — exclude the
    # boundary explicitly so "strictly inside" means interior membership
    shell = geom.exterior.coords_array
    inside = (_points_in_ring(shell, xs, ys, strict=True)
              & ~_points_on_ring_edges(shell, np.asarray(xs, np.float64),
                                       np.asarray(ys, np.float64)))
    for h in geom.interiors:
        inside &= ~_points_in_ring(h.coords_array, xs, ys)
    return inside


def _segments_cross_strict(p1, p2, p3, p4) -> bool:
    """True only for a PROPER crossing (interiors intersect at one point);
    shared endpoints, endpoint-on-segment and collinear overlap are all
    excluded — ``within`` permits boundary contact."""
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)
    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    return o1 * o2 < 0 and o3 * o4 < 0


def _proper_boundary_crossing(inner: Geometry, outer: Geometry) -> bool:
    for r1 in _paths_of(inner):
        for r2 in _paths_of(outer):
            if not _bbox_overlap((r1[:, 0].min(), r1[:, 1].min(),
                                  r1[:, 0].max(), r1[:, 1].max()),
                                 (r2[:, 0].min(), r2[:, 1].min(),
                                  r2[:, 0].max(), r2[:, 1].max())):
                continue
            for i in range(len(r1) - 1):
                for j in range(len(r2) - 1):
                    if _segments_cross_strict(r1[i], r1[i + 1],
                                              r2[j], r2[j + 1]):
                        return True
    return False


def _within(inner: Geometry, outer: Geometry) -> bool:
    if not isinstance(outer, (Polygon, MultiPolygon)):
        return False
    if isinstance(inner, Point):
        return bool(outer.contains_points(np.array(inner.x),
                                          np.array(inner.y)))
    if getattr(inner, "is_empty", False):
        return False  # shapely: empty geometries are within nothing
    rings = _paths_of(inner)  # polygon rings, or the LineString path
    if not rings:
        return False
    # all vertices AND edge midpoints inside (midpoints catch edges that
    # leave a concave outer or span a hole between two inside vertices) …
    for r in rings:
        mid = (r[:-1] + r[1:]) * 0.5
        xs = np.concatenate([r[:, 0], mid[:, 0]])
        ys = np.concatenate([r[:, 1], mid[:, 1]])
        if not outer.contains_points(xs, ys).all():
            return False
    # … and no inner edge PROPERLY crosses the outer boundary (touching
    # is allowed: within() permits shared boundary points)
    return not _proper_boundary_crossing(inner, outer)
