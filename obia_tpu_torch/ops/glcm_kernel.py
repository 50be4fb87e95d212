"""Per-object GLCM sums: the hand-written CUDA kernel and its plain twin.

:func:`glcm_sums` is the one entry point. For a CUDA tensor it launches
``csrc/glcm.cu`` (which replaces ``obia_tpu/ops/glcm_pallas.py::_kernel``)
or raises; for a CPU tensor it runs :func:`glcm_sums_reference`, the same
function in plain torch. Both return

* ``isums`` (A, K, 7) int64: n, sum d^2, sum |d|, sum(i+j), sum(i^2+j^2),
  sum ij over the ordered (centre, neighbour) level pairs of each object at
  each offset, and sum (C + C^T)^2 over its symmetric co-occurrence table;
* ``hsum`` (A, K) float64: sum 1/(1+d^2).

A pair counts when its centre lies in object k's box ``bboxes[k]``, its
neighbour (r + dr, c + dc) lies in the raster, and both pixels carry label
k. Levels are ``clip(floor((v - mn_k) * inv_k), 0, L - 1)``
(``obia_tpu/ops/glcm.scale_quantise``). The sharded path passes a block
with a halo and boxes clipped to the block's centre, so a pair across a seam
counts once, on the shard that owns its centre pixel.
The integer sums are exact, so kernel and twin agree bitwise on them.

:func:`glcm_hist` (``csrc/glcm.cu`` ``glcm_hist_kernel``, which replaces
``obia_tpu/ops/glcm_pallas.py::_hist_kernel``) counts the same pairs of a
few objects into their full directed co-occurrence tables, (M, L, A*L)
int32 indexed [slot, centre level, angle*L + neighbour level]; its twin is
:func:`glcm_hist_reference`. The sharded GLCM sums those tables over the
shards for the objects that span a seam, whose sum (C + C^T)^2 is not a sum
of per-shard values.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

launches = 0  # glcm_sums kernel launches in this process; twins never count
hist_launches = 0  # glcm_hist kernel launches in this process


def glcm_sums(labels: torch.Tensor, image: torch.Tensor, band: int,
              bboxes: torch.Tensor, mn: torch.Tensor, inv: torch.Tensor,
              levels: int, offsets: Sequence[Tuple[int, int]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums for every object of one band.

    labels: (H, W) int32, -1 outside every object, objects 0..K-1.
    image: (H, W, C) float32; ``band`` selects the channel.
    bboxes: (K, 4) int32 [rmin, rmax, cmin, cmax] (rmin > rmax: empty).
    mn, inv: (K,) float32 quantiser minimum and (L-1)/range per object.
    """
    if labels.device.type == "cpu":
        return glcm_sums_reference(labels, image, band, bboxes, mn, inv,
                                   levels, offsets)
    if labels.device.type != "cuda":
        raise ValueError(f"glcm_sums: unsupported device {labels.device}")
    H, W = labels.shape
    K = bboxes.shape[0]
    _check(labels, (H, W), torch.int32, "labels")
    if image.dim() != 3 or image.shape[:2] != (H, W):
        raise ValueError(f"image shape {tuple(image.shape)} does not match "
                         f"labels {(H, W)}")
    _check(image, tuple(image.shape), torch.float32, "image")
    _check(bboxes, (K, 4), torch.int32, "bboxes")
    _check(mn, (K,), torch.float32, "mn")
    _check(inv, (K,), torch.float32, "inv")
    for name, t in (("image", image), ("bboxes", bboxes), ("mn", mn),
                    ("inv", inv)):
        if t.device != labels.device:
            raise ValueError(f"{name} is on {t.device}, labels on "
                             f"{labels.device}")
    C = image.shape[2]
    if not 0 <= band < C:
        raise IndexError(f"band {band} out of range 0..{C - 1}")
    if not 1 <= levels <= 256:
        raise ValueError(f"levels={levels} out of range 1..256")
    A = len(offsets)
    if not 1 <= A <= 8:
        raise ValueError(f"{A} offsets: the kernel takes 1..8")
    isums = torch.zeros((A, K, 7), dtype=torch.int64, device=labels.device)
    hsum = torch.zeros((A, K), dtype=torch.float64, device=labels.device)
    if K == 0:
        return isums, hsum

    from .. import _build
    lib = _build.load()
    offs = (ctypes.c_int * (2 * A))(*[v for o in offsets for v in o])
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        status = lib.obia_glcm_sums(
            labels.data_ptr(), image.data_ptr() + 4 * band, H, W, C,
            bboxes.data_ptr(), mn.data_ptr(), inv.data_ptr(), K, levels,
            offs, A, isums.data_ptr(), hsum.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"GLCM kernel launch failed: CUDA error {status}")
    global launches
    launches += 1
    return isums, hsum


def _check(t: torch.Tensor, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def quantise_pixels(labels: torch.Tensor, plane: torch.Tensor,
                    mn: torch.Tensor, inv: torch.Tensor,
                    levels: int) -> torch.Tensor:
    """(H, W) int64 levels of every pixel under its own object's quantiser
    (pixels outside every object read object 0's and are never used): the
    reference ``scale_quantise`` with the inverse precomputed per object.
    Kept in the subtract-then-multiply form: a division form drifted
    contrast by about 1.6e-3 through level flips at bin edges."""
    lab = labels.long().clamp(min=0)
    scaled = (plane - mn[lab]) * inv[lab]
    return torch.clamp(torch.floor(scaled), 0, levels - 1).long()


def glcm_sums_reference(labels: torch.Tensor, image: torch.Tensor, band: int,
                        bboxes: torch.Tensor, mn: torch.Tensor,
                        inv: torch.Tensor, levels: int,
                        offsets: Sequence[Tuple[int, int]]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel. Shifted slices give the pairs,
    ``index_add_`` the int64 sums, and canonical (object, lo, hi) keys with
    ``unique`` the squared counts."""
    K = bboxes.shape[0]
    L = levels
    dev = labels.device
    q = quantise_pixels(labels, image[..., band], mn, inv, L)
    lab = labels.long()
    inb = _centres_in_box(lab, bboxes)
    isums = torch.zeros((len(offsets), K, 7), dtype=torch.int64, device=dev)
    hsum = torch.zeros((len(offsets), K), dtype=torch.float64, device=dev)
    d_axis = torch.arange(L, dtype=torch.float64, device=dev)
    h_weight = 1.0 / (1.0 + d_axis * d_axis)
    for a, (dr, dc) in enumerate(offsets):
        k, q1, q2 = _pairs(lab, q, inb, dr, dc)
        if k.numel() == 0:
            continue
        d = (q1 - q2).abs()
        terms = torch.stack([torch.ones_like(d), d * d, d, q1 + q2,
                             q1 * q1 + q2 * q2, q1 * q2], dim=1)
        isums[a, :, :6].index_add_(0, k, terms)
        dhist = torch.bincount(k * L + d, minlength=K * L).view(K, L)
        hsum[a] = (dhist.double() * h_weight).sum(dim=1)
        lo, hi = torch.minimum(q1, q2), torch.maximum(q1, q2)
        keys, counts = torch.unique((k * L + lo) * L + hi,
                                    return_counts=True)
        diag = (keys // L) % L == keys % L
        sq = counts * counts * torch.where(diag, 4, 2)
        isums[a, :, 6].index_add_(0, keys // (L * L), sq)
    return isums, hsum


def _centres_in_box(lab: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: the pixel carries an object's label and lies in that
    object's box, so it may be the centre of a pair. One pass over the
    raster, shared by every offset."""
    H, W = lab.shape
    if bboxes.shape[0] == 0:
        return torch.zeros((H, W), dtype=torch.bool, device=lab.device)
    k = lab.clamp(min=0)
    rr = torch.arange(H, device=lab.device)[:, None]
    cc = torch.arange(W, device=lab.device)[None, :]
    return ((lab >= 0) & (rr >= bboxes[:, 0][k]) & (rr <= bboxes[:, 1][k])
            & (cc >= bboxes[:, 2][k]) & (cc <= bboxes[:, 3][k]))


def _pairs(lab: torch.Tensor, q: torch.Tensor, inb: torch.Tensor,
           dr: int, dc: int):
    """(object, centre level, neighbour level) of every pair at offset
    (dr, dc) whose centre is in its object's box (``inb``), all int64 (P,)."""
    H, W = lab.shape
    r0, r1 = max(0, -dr), min(H, H - dr)
    c0, c1 = max(0, -dc), min(W, W - dc)
    if r1 <= r0 or c1 <= c0:
        empty = torch.zeros(0, dtype=torch.int64, device=lab.device)
        return empty, empty, empty
    la = lab[r0:r1, c0:c1]
    ok = inb[r0:r1, c0:c1] & (la == lab[r0 + dr:r1 + dr, c0 + dc:c1 + dc])
    return (la[ok], q[r0:r1, c0:c1][ok],
            q[r0 + dr:r1 + dr, c0 + dc:c1 + dc][ok])


def glcm_hist(labels: torch.Tensor, image: torch.Tensor, band: int,
              objs: torch.Tensor, bboxes: torch.Tensor, mn: torch.Tensor,
              inv: torch.Tensor, levels: int,
              offsets: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Directed co-occurrence tables of the objects ``objs`` for one band:
    (M, L, A*L) int32, entry [m, i, a*L + j] the number of pairs at offset
    a with centre level i and neighbour level j of object ``objs[m]``.

    labels, image, band, mn, inv: as :func:`glcm_sums` (mn and inv (K,)).
    objs: (M,) int32 object ids; bboxes: (M, 4) int32 boxes of the centre
    pixels to visit for each of them (rmin > rmax: none). The kernel leaves
    the table of an id outside 0..K-1 at zero (checked on the device, so a
    launch needs no host sync); the twin raises on one.
    """
    if labels.device.type == "cpu":
        return glcm_hist_reference(labels, image, band, objs, bboxes, mn,
                                   inv, levels, offsets)
    if labels.device.type != "cuda":
        raise ValueError(f"glcm_hist: unsupported device {labels.device}")
    H, W = labels.shape
    M = objs.shape[0]
    K = mn.shape[0]
    _check(labels, (H, W), torch.int32, "labels")
    if image.dim() != 3 or image.shape[:2] != (H, W):
        raise ValueError(f"image shape {tuple(image.shape)} does not match "
                         f"labels {(H, W)}")
    _check(image, tuple(image.shape), torch.float32, "image")
    _check(objs, (M,), torch.int32, "objs")
    _check(bboxes, (M, 4), torch.int32, "bboxes")
    _check(mn, (K,), torch.float32, "mn")
    _check(inv, (K,), torch.float32, "inv")
    for name, t in (("image", image), ("objs", objs), ("bboxes", bboxes),
                    ("mn", mn), ("inv", inv)):
        if t.device != labels.device:
            raise ValueError(f"{name} is on {t.device}, labels on "
                             f"{labels.device}")
    C = image.shape[2]
    if not 0 <= band < C:
        raise IndexError(f"band {band} out of range 0..{C - 1}")
    if not 1 <= levels <= 256:
        raise ValueError(f"levels={levels} out of range 1..256")
    A = len(offsets)
    if not 1 <= A <= 8:
        raise ValueError(f"{A} offsets: the kernel takes 1..8")
    out = torch.zeros((M, levels, A * levels), dtype=torch.int32,
                      device=labels.device)
    if M == 0:
        return out

    from .. import _build
    lib = _build.load()
    offs = (ctypes.c_int * (2 * A))(*[v for o in offsets for v in o])
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        status = lib.obia_glcm_hist(
            labels.data_ptr(), image.data_ptr() + 4 * band, H, W, C,
            objs.data_ptr(), bboxes.data_ptr(), mn.data_ptr(), inv.data_ptr(),
            M, K, levels, offs, A, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"GLCM histogram kernel launch failed: CUDA error "
                           f"{status}")
    global hist_launches
    hist_launches += 1
    return out


def glcm_hist_reference(labels: torch.Tensor, image: torch.Tensor,
                        band: int, objs: torch.Tensor, bboxes: torch.Tensor,
                        mn: torch.Tensor, inv: torch.Tensor, levels: int,
                        offsets: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Plain-torch twin of the histogram kernel: the pairs of
    :func:`glcm_sums_reference`, counted with one ``bincount`` over
    (slot, centre level, neighbour level) per angle."""
    M = objs.shape[0]
    K = mn.shape[0]
    L = levels
    A = len(offsets)
    dev = labels.device
    out = torch.zeros((M, L, A * L), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    q = quantise_pixels(labels, image[..., band], mn, inv, L)
    slot_of = torch.full((K,), -1, dtype=torch.int64, device=dev)
    slot_of[objs.long()] = torch.arange(M, device=dev)
    box = torch.tensor([[1, 0, 1, 0]], dtype=torch.int32, device=dev).repeat(
        K, 1)                               # objects not in objs: no centres
    box[objs.long()] = bboxes
    lab = labels.long()
    inb = _centres_in_box(lab, box)
    for a, (dr, dc) in enumerate(offsets):
        k, q1, q2 = _pairs(lab, q, inb, dr, dc)
        s = slot_of[k]
        hist = torch.bincount((s * L + q1) * L + q2, minlength=M * L * L)
        out[:, :, a * L:(a + 1) * L] = hist.view(M, L, L).to(torch.int32)
    return out
