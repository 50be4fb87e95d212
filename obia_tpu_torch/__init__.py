"""obia_tpu_torch: the OBIA main path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``obia_tpu`` (JAX/XLA/Pallas), which stays the reference. It
mirrors that package's module layout and imports nothing of it. The code is
plain torch; entry points whose input is not yet a tensor run on the card
unless given ``device="cpu"`` (:mod:`obia_tpu_torch.device`), and functions
that take tensors follow their tensors. Every Pallas kernel on the ported
path is a CUDA kernel under ``csrc/``, built with nvcc at first use
(:mod:`obia_tpu_torch._build`). The host layer is the port's own:
``geometry`` (affine, CRS, polygons, points), ``io`` (the GeoTIFF reader
and writer, the GeoPackage writer), ``vector`` (the pandas ``GeoDataFrame``
and ``sjoin``) and ``native`` (the C++ polygoniser, union-find and TreeSHAP,
built with g++ at first use).

    from obia_tpu_torch.handlers.geotif import open_geotiff, image_from_array
    from obia_tpu_torch.segmentation.segment import segment, Segments
    from obia_tpu_torch.classification.forest import TorchForestClassifier
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    from obia_tpu_torch.classification.classify import classify
    from obia_tpu_torch.utils.utils import label_segments
    from obia_tpu_torch.utils.tiling import create_tiled_segments
    from obia_tpu_torch.parallel.mosaic import segment_mosaic

Importing the package switches TF32 off for float32 matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so reductions stay in true float32 on
the card as they are in the reference.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["__version__", "open_geotiff", "image_from_array", "segment",
           "TorchForestClassifier", "TorchMLPClassifier", "classify",
           "label_segments", "create_tiled_segments", "segment_mosaic"]


def __getattr__(name):
    """Lazy top-level exports (the submodules load on first use)."""
    if name in ("open_geotiff", "image_from_array"):
        from .handlers import geotif
        return getattr(geotif, name)
    if name == "segment":
        from .segmentation.segment import segment
        return segment
    if name == "TorchForestClassifier":
        from .classification.forest import TorchForestClassifier
        return TorchForestClassifier
    if name == "TorchMLPClassifier":
        from .classification.mlp import TorchMLPClassifier
        return TorchMLPClassifier
    if name == "classify":
        from .classification.classify import classify
        return classify
    if name == "label_segments":
        from .utils.utils import label_segments
        return label_segments
    if name == "create_tiled_segments":
        from .utils.tiling import create_tiled_segments
        return create_tiled_segments
    if name == "segment_mosaic":
        from .parallel.mosaic import segment_mosaic
        return segment_mosaic
    raise AttributeError(f"module 'obia_tpu_torch' has no attribute {name!r}")
