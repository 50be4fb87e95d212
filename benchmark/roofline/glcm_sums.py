"""The least time of ``glcm_sums``, one call a band: the (H, W) int32
labels and the float32 band read once, each object's box (4 int32) and
quantiser (2 float32) read once, and the (A, K, 7) int64 sums and (A, K)
float64 sums written once, over the HBM's bandwidth. Its integer work per
pixel is far under the bytes."""
from . import HBM_BYTES_PER_MS

KERNELS = ("glcm_pack_kernel", "glcm_small_kernel", "glcm_large_kernel")


def call_bytes(H: int, W: int, K: int, A: int) -> int:
    """Bytes one call must move: 8 a pixel, 24 an object, 64 an (angle,
    object)."""
    return 4 * H * W + 4 * H * W + 24 * K + 64 * A * K


def bound_ms(scene: dict) -> float:
    """Least time of a scene's calls, one for each texture band:
    ``scene`` holds H, W, K, angles and texture_bands."""
    per_call = call_bytes(scene["H"], scene["W"], scene["K"],
                          scene["angles"])
    return scene["texture_bands"] * per_call / HBM_BYTES_PER_MS
