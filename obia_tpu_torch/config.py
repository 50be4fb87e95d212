"""Typed configuration dataclasses (the port's copy of
``obia_tpu/config.py``).

They give the keyword arguments of the port's functions a typed, validated
home; each config's ``kwargs()`` expands back into the exact keyword
arguments the corresponding function accepts (None fields are left out):

    cfg = SlicConfig(n_segments=3000, compactness=10)
    layer = create_segments(image, device="cpu", **cfg.kwargs())

``SlicConfig`` and ``QuickshiftConfig`` feed
``segmentation.segment_boundaries.create_segments``, ``StatsConfig``
``segmentation.segment_statistics.create_objects``, ``ClassifyConfig``
``classification.classify.classify``, ``TilingConfig``
``utils.tiling.create_tiled_segments`` and ``MosaicConfig``
``parallel.mosaic.mosaic_pipeline``, whose mesh is its own argument: the
port has no ``n_devices``, so that field must stay None there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


class _Config:
    def kwargs(self) -> dict:
        return {f.name: v for f in dataclasses.fields(self)
                if (v := getattr(self, f.name)) is not None}

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclass(frozen=True)
class SlicConfig(_Config):
    n_segments: int = 100
    compactness: float = 10.0
    max_num_iter: int = 10
    sigma: float = 0.0
    enforce_connectivity: bool = True
    min_size_factor: float = 0.5
    max_size_factor: float = 3.0
    start_label: int = 1

    def __post_init__(self):
        if self.n_segments < 1:
            raise ValueError("n_segments must be >= 1")
        if self.compactness <= 0:
            raise ValueError("compactness must be > 0")


@dataclass(frozen=True)
class QuickshiftConfig(_Config):
    ratio: float = 1.0
    kernel_size: float = 5.0
    max_dist: float = 10.0
    sigma: float = 0.0
    random_seed: int = 42

    def __post_init__(self):
        if self.kernel_size <= 0 or self.max_dist <= 0:
            raise ValueError("kernel_size and max_dist must be > 0")


@dataclass(frozen=True)
class StatsConfig(_Config):
    calc_mean: bool = True
    calc_variance: bool = True
    calc_min: bool = True
    calc_max: bool = True
    calc_skewness: bool = True
    calc_kurtosis: bool = True
    calc_contrast: bool = True
    calc_dissimilarity: bool = True
    calc_homogeneity: bool = True
    calc_ASM: bool = True
    calc_energy: bool = True
    calc_correlation: bool = True


@dataclass(frozen=True)
class ClassifyConfig(_Config):
    method: str = "rf"
    test_size: float = 0.2
    compute_reports: bool = False
    compute_shap: bool = False
    strict_reference_scaling: bool = False

    def __post_init__(self):
        if self.method not in ("rf", "mlp"):
            raise ValueError("method must be 'rf' or 'mlp'")
        if not 0 < self.test_size < 1:
            raise ValueError("test_size must be in (0, 1)")


@dataclass(frozen=True)
class TilingConfig(_Config):
    tile_size: int = 200
    buffer: int = 30
    crown_radius: float = 5.0
    resume: bool = False
    retries: int = 1

    def __post_init__(self):
        if self.buffer >= self.tile_size:
            raise ValueError("buffer must be smaller than tile_size")


@dataclass(frozen=True)
class MosaicConfig(_Config):
    n_segments: int = 1000
    compactness: float = 10.0
    max_num_iter: int = 10
    min_size_factor: float = 0.5
    n_devices: Optional[int] = None
