"""Per-object GLCM sums: the hand-written CUDA kernel and its plain twin.

:func:`glcm_sums` is the one entry point. For a CUDA tensor it launches
``csrc/glcm.cu`` (which replaces ``obia_tpu/ops/glcm_pallas.py::_kernel``:
a pack pass, a warp per object whose box holds at most
:data:`SMALL_MAX_PX` pixels, and persistent blocks for the larger objects,
all chosen on the device) or raises; for a CPU tensor it runs
:func:`glcm_sums_reference`, the same function in plain torch. Both return

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

:func:`glcm_spanner_hist` (``csrc/glcm.cu`` ``glcm_spanner_hist_kernel``,
which replaces ``obia_tpu/ops/glcm_pallas.py::_hist_kernel`` and the psum
and square after it) serves the sharded GLCM: for the objects that span a
shard seam, whose sum (C + C^T)^2 is not a sum of per-shard values, it
counts the same pairs over every shard's piece of each object into one
directed co-occurrence table, (M, L, A*L) int32 indexed [spanner, centre
level, angle*L + neighbour level], and gives that table's exact (A, M)
int64 sum (C + C^T)^2, in one launch a band. Its twin
:func:`glcm_spanner_hist_reference` sums :func:`glcm_hist_reference`, the
tables of one shard, over the shards and squares the sum with
:func:`symmetric_sumsq`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import telemetry

_SUMSQ_CHUNK = 64  # tables the twin squares at a time
# the most pixels of an object's box (clipped to the raster) that the
# warp-per-object kernel sums; larger boxes go to the block-per-item kernel.
# The kernel's own constant is GLCM_SMALL_CAP in csrc/glcm.cu; this mirror
# is for the tests, which hold the two equal.
SMALL_MAX_PX = 256


def glcm_sums(labels: torch.Tensor, image: torch.Tensor, band: int,
              bboxes: torch.Tensor, mn: torch.Tensor, inv: torch.Tensor,
              levels: int, offsets: Sequence[Tuple[int, int]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums for every object of one band.

    labels: (H, W) int32, -1 outside every object, objects 0..K-1.
    image: (H, W, C) float32; ``band`` selects the channel.
    bboxes: (K, 4) int32 [rmin, rmax, cmin, cmax] (rmin > rmax: empty).
    mn, inv: (K,) float32 quantiser minimum and (L-1)/range per object.
    On the card K must be below 2^23 (the kernel packs the label into 23
    bits) and one call counts one launch, however many kernels it starts.
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
    if K >= 1 << 23:
        raise ValueError(f"K={K} objects: the kernel takes fewer than 2^23")
    isums = torch.empty((A, K, 7), dtype=torch.int64, device=labels.device)
    hsum = torch.empty((A, K), dtype=torch.float64, device=labels.device)
    if K == 0 or H * W == 0:
        return isums.zero_(), hsum.zero_()
    # packed levels (H*W), the ids of the large objects (K), two counters
    scratch = torch.empty(H * W + K + 2, dtype=torch.int32,
                          device=labels.device)

    from .. import _build
    lib = _build.load()
    offs = (ctypes.c_int * (2 * A))(*[v for o in offsets for v in o])
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        status = lib.obia_glcm_sums(
            labels.data_ptr(), image.data_ptr() + 4 * band, H, W, C,
            bboxes.data_ptr(), mn.data_ptr(), inv.data_ptr(), K, levels,
            offs, A, scratch.data_ptr(), isums.data_ptr(), hsum.data_ptr(),
            stream)
    if status != 0:
        raise RuntimeError(f"GLCM kernel launch failed: CUDA error {status}")
    telemetry.count("kernel.glcm_sums")  # the twin never counts
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


class SpannerPieces(NamedTuple):
    """The pieces of M seam spanners as a CSR list, on one device.

    ids: (M,) int32 object ids, ascending; ptr: (M + 1,) int32, spanner m's
    pieces are rows ptr[m]..ptr[m+1]-1 of pieces: (P, 5) int32 [shard,
    rmin, rmax, cmin, cmax], the box of its centre pixels on that shard in
    the shard's block coordinates, at most one a (spanner, shard), sorted by
    (spanner, shard)."""
    ids: torch.Tensor
    ptr: torch.Tensor
    pieces: torch.Tensor


def spanner_pieces(ids: torch.Tensor, objs: Sequence[torch.Tensor],
                   boxes: Sequence[torch.Tensor]) -> SpannerPieces:
    """The CSR list of ``ids`` ((M,) ascending) from each shard s's (M_s,)
    int32 ids ``objs[s]`` (a subset of ``ids``) and their (M_s, 4) int32
    boxes ``boxes[s]``, on ``ids``' device, with no host sync."""
    dev = ids.device
    M, S = ids.numel(), len(objs)
    shard = torch.cat([torch.full((o.numel(),), s, dtype=torch.int64,
                                  device=dev) for s, o in enumerate(objs)])
    obj = torch.cat([o.to(dev).long() for o in objs])
    box = torch.cat([b.to(dev).to(torch.int32).reshape(-1, 4)
                     for b in boxes])
    rank = torch.searchsorted(ids.long(), obj)
    order = torch.argsort(rank * S + shard)
    pieces = torch.cat([shard[:, None].to(torch.int32), box], 1)[order]
    # index_add_ and not bincount, which reads its input's max on the host
    ptr = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    ptr.index_add_(0, rank + 1, torch.ones_like(rank))
    ptr = torch.cumsum(ptr, 0)
    return SpannerPieces(ids.to(torch.int32).contiguous(),
                         ptr.to(torch.int32), pieces.contiguous())


def glcm_spanner_hist(labels: Sequence[torch.Tensor],
                      images: Sequence[torch.Tensor], band: int,
                      work: SpannerPieces, mn: torch.Tensor,
                      inv: torch.Tensor, levels: int,
                      offsets: Sequence[Tuple[int, int]],
                      tables: bool = True
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The seam spanners' directed tables of one band summed over the
    shards, (M, L, A*L) int32 (entry [m, i, a*L + j] the pairs at offset a
    of object ``work.ids[m]`` with centre level i and neighbour level j),
    or None when ``tables`` is false, and each table's exact sum
    (C + C^T)^2, (A, M) int64.

    labels, images: every shard's block with its halo, (H, W) int32 and
    (H, W, C) float32, all of one shape and on one device; ``band`` selects
    the channel. work: the pieces (:func:`spanner_pieces`); a piece's shard
    indexes ``labels``. mn, inv: (K,) float32 quantisers, as
    :func:`glcm_sums`. Without ``tables`` the kernel stores no table, only
    the sums. The kernel leaves the table and the sum of an id outside
    0..K-1 at zero (checked on the device, so a launch needs no host sync);
    the twin raises on one.
    """
    dev = labels[0].device
    if dev.type == "cpu":
        out, sumsq = glcm_spanner_hist_reference(
            labels, images, band, work, mn, inv, levels, offsets)
        return (out if tables else None), sumsq
    if dev.type != "cuda":
        raise ValueError(f"glcm_spanner_hist: unsupported device {dev}")
    S = len(labels)
    if S == 0 or len(images) != S:
        raise ValueError(f"{S} label blocks and {len(images)} image blocks")
    H, W = labels[0].shape
    C = images[0].shape[-1]
    M, P = work.ids.shape[0], work.pieces.shape[0]
    K = mn.shape[0]
    for s in range(S):
        _check(labels[s], (H, W), torch.int32, f"labels[{s}]")
        _check(images[s], (H, W, C), torch.float32, f"images[{s}]")
    _check(work.ids, (M,), torch.int32, "ids")
    _check(work.ptr, (M + 1,), torch.int32, "ptr")
    _check(work.pieces, (P, 5), torch.int32, "pieces")
    _check(mn, (K,), torch.float32, "mn")
    _check(inv, (K,), torch.float32, "inv")
    A = len(offsets)
    named = [*(("labels", t) for t in labels), *(("images", t) for t in images),
             ("ids", work.ids), ("ptr", work.ptr), ("pieces", work.pieces),
             ("mn", mn), ("inv", inv)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, labels[0] on {dev}")
    if not 0 <= band < C:
        raise IndexError(f"band {band} out of range 0..{C - 1}")
    if not 1 <= levels <= 256:
        raise ValueError(f"levels={levels} out of range 1..256")
    if not 1 <= A <= 8:
        raise ValueError(f"{A} offsets: the kernel takes 1..8")
    if H * W >= 1 << 31:
        raise ValueError(f"blocks of {H} x {W} pixels: the kernel takes "
                         f"fewer than 2^31")
    out = (torch.empty((M, levels, A * levels), dtype=torch.int32,
                       device=dev) if tables else None)
    sumsq = torch.empty((A, M), dtype=torch.int64, device=dev)
    if M == 0:
        return out, sumsq
    # the blocks' addresses, read by the kernel: one small copy a call, from
    # pinned memory so that it does not wait for the stream
    bases = torch.tensor([[t.data_ptr() for t in labels],
                          [t.data_ptr() for t in images]],
                         dtype=torch.int64).pin_memory().to(dev,
                                                            non_blocking=True)

    from .. import _build
    lib = _build.load()
    offs = (ctypes.c_int * (2 * A))(*[v for o in offsets for v in o])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.obia_glcm_spanner_hist(
            bases[0].data_ptr(), bases[1].data_ptr(), S, H, W, C, band,
            work.ids.data_ptr(), work.ptr.data_ptr(),
            work.pieces.data_ptr(), M, mn.data_ptr(), inv.data_ptr(), K,
            levels, offs, A, None if out is None else out.data_ptr(),
            sumsq.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"GLCM spanner histogram kernel launch failed: "
                           f"CUDA error {status}")
    telemetry.count("kernel.glcm_hist")
    return out, sumsq


def glcm_spanner_hist_reference(labels: Sequence[torch.Tensor],
                                images: Sequence[torch.Tensor], band: int,
                                work: SpannerPieces, mn: torch.Tensor,
                                inv: torch.Tensor, levels: int,
                                offsets: Sequence[Tuple[int, int]]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`glcm_spanner_hist`: each shard's tables
    (:func:`glcm_hist_reference`) summed with ``index_add_``, then
    :func:`symmetric_sumsq`."""
    M = work.ids.shape[0]
    L, A = levels, len(offsets)
    dev = labels[0].device
    out = torch.zeros((M, L, A * L), dtype=torch.int32, device=dev)
    spanner = torch.repeat_interleave(
        torch.arange(M, device=dev), (work.ptr[1:] - work.ptr[:-1]).long())
    for s, (lab, img) in enumerate(zip(labels, images)):
        on = work.pieces[:, 0] == s
        if not bool(on.any()):
            continue
        m = spanner[on]
        out.index_add_(0, m, glcm_hist_reference(
            lab, img, band, work.ids[m], work.pieces[on, 1:].contiguous(),
            mn, inv, L, offsets))
    return out, symmetric_sumsq(out, A, L)


def symmetric_sumsq(tables: torch.Tensor, n_angles: int, levels: int
                    ) -> torch.Tensor:
    """(A, M) int64 sum over (i, j) of (C + C^T)^2 of (M, L, A*L) directed
    tables, exact."""
    M = tables.shape[0]
    L = levels
    out = torch.zeros((n_angles, M), dtype=torch.int64, device=tables.device)
    for a in range(n_angles):
        for m0 in range(0, M, _SUMSQ_CHUNK):
            C = tables[m0:m0 + _SUMSQ_CHUNK, :, a * L:(a + 1) * L].long()
            S = C + C.transpose(1, 2)
            out[a, m0:m0 + _SUMSQ_CHUNK] = (S * S).sum(dim=(1, 2))
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
