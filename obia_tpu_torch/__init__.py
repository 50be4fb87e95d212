"""obia_tpu_torch: the OBIA main path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``obia_tpu`` (JAX/XLA/Pallas), which stays the reference. It
mirrors that package's module layout; the code is plain torch on tensors
with an explicit ``device`` (the input's device otherwise), and every
Pallas kernel on the ported path is a CUDA kernel under ``csrc/``, built
with nvcc at first use (:mod:`obia_tpu_torch._build`). It shares the
jax-free host layer of ``obia_tpu``: ``geometry``, ``io``, ``native`` (the
C++ polygoniser) and ``config``.

    from obia_tpu_torch.handlers.geotif import open_geotiff, image_from_array
    from obia_tpu_torch.segmentation.segment import segment, Segments
    from obia_tpu_torch.classification.forest import TorchForestClassifier

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
           "TorchForestClassifier"]


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
    raise AttributeError(f"module 'obia_tpu_torch' has no attribute {name!r}")
