"""Connected components and small-segment merging (port of
``obia_tpu/ops/connectivity.py``).

* :func:`ccl_dense_labels`: exact 4-connected components of a label raster
  by min-label propagation with hooking and pointer jumping (FastSV), run to
  its fixpoint with a convergence check on the host, then the dense
  first-occurrence relabel. A component's root is its minimum linear index,
  so ranking roots in ascending order numbers components by raster-order
  first occurrence: the numbering of the reference's scan CCL, bitwise.
* :func:`merge_small_device`: segments smaller than ``min_size`` adopt an
  adjacent label through adoption sweeps over the deduplicated
  label-adjacency edge list (capped by ``max_size``, then uncapped so no
  sub-minimum orphan survives), then a dense re-compaction. The sweeps are
  integer min-reductions, so the result is the same whatever order the
  atomics run in.

Each propagation sweep and each adoption sweep ends in a host sync; the
telemetry counts them as ``ccl.sweeps`` and ``merge.sweeps``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import telemetry


def _same_masks(labels: torch.Tensor):
    """(same-as-left, same-as-up) masks: the pixel is valid and carries the
    label of its left (upper) neighbour. Column (row) 0 is False."""
    H, W = labels.shape
    same_l = torch.zeros((H, W), dtype=torch.bool, device=labels.device)
    same_u = torch.zeros((H, W), dtype=torch.bool, device=labels.device)
    same_l[:, 1:] = (labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)
    same_u[1:, :] = (labels[1:, :] == labels[:-1, :]) & (labels[1:, :] >= 0)
    return same_l, same_u


def ccl_roots(labels: torch.Tensor) -> torch.Tensor:
    """(H, W) int64 component roots (minimum linear index of each
    4-connected equal-label component); -1 where labels < 0."""
    H, W = labels.shape
    N = H * W
    dev = labels.device
    valid = (labels >= 0).reshape(-1)
    same_l, same_u = _same_masks(labels)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    comp = torch.where(valid, idx, N)       # N = +inf, never a valid root
    vidx = idx[valid]
    while True:
        telemetry.count("ccl.sweeps")  # each sweep ends in a host sync
        c2 = comp.view(H, W)
        m = c2.clone()                      # min over self + same neighbours
        m[:, 1:] = torch.minimum(m[:, 1:], torch.where(
            same_l[:, 1:], c2[:, :-1], N))
        m[:, :-1] = torch.minimum(m[:, :-1], torch.where(
            same_l[:, 1:], c2[:, 1:], N))
        m[1:, :] = torch.minimum(m[1:, :], torch.where(
            same_u[1:, :], c2[:-1, :], N))
        m[:-1, :] = torch.minimum(m[:-1, :], torch.where(
            same_u[1:, :], c2[1:, :], N))
        m = m.reshape(-1)
        nxt = comp.clone()
        # hook each parent onto the smallest label seen by its children
        nxt.scatter_reduce_(0, comp[vidx], m[vidx], "amin")
        nxt = torch.minimum(nxt, m)
        # pointer jumping
        nxt[vidx] = nxt[nxt[vidx]]
        if torch.equal(nxt, comp):
            break
        comp = nxt
    return torch.where(valid, comp, -1).view(H, W)


def dense_relabel(roots: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Fully compressed roots -> (int32 labels 0..K-1 by ascending root,
    -1 invalid; K) (reference ``_dense_relabel_device``)."""
    f = roots.reshape(-1)
    idx = torch.arange(f.numel(), dtype=torch.int64, device=f.device)
    valid = f >= 0
    is_root = valid & (f == idx)
    rank = torch.cumsum(is_root.to(torch.int64), 0) - 1
    lab = torch.where(valid, rank[torch.where(valid, f, 0)], -1)
    return lab.to(torch.int32).view(roots.shape), int(is_root.sum())


def ccl_dense_labels(labels: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(H, W) labels -> (dense connected labels 0..K-1 / -1, K)."""
    return dense_relabel(ccl_roots(labels))


def label_edges(labels: torch.Tensor, num_labels: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicated label-adjacency edges (lo < hi) over 4-neighbour pixel
    pairs with different valid labels, in ascending (lo, hi) order."""
    lab = labels.long()
    keys = []
    for a, b in ((lab[:, :-1], lab[:, 1:]), (lab[:-1, :], lab[1:, :])):
        m = (a != b) & (a >= 0) & (b >= 0)
        lo = torch.minimum(a[m], b[m])
        hi = torch.maximum(a[m], b[m])
        keys.append(lo * num_labels + hi)
    key = torch.unique(torch.cat(keys))
    return key // num_labels, key % num_labels


def _sweep(ea, eb, lut, sizes0, min_size: int, max_size: int, K: int,
           capped: bool):
    """One adoption sweep (reference ``_merge_small_sweep_edges`` =
    ``_sweep_biased`` + ``_sweep_apply``). Returns (lut, adopted any)."""
    iota = torch.arange(K, dtype=torch.int64, device=lut.device)
    sizes = torch.zeros(K, dtype=torch.int64,
                        device=lut.device).index_add_(0, lut, sizes0)
    small = (sizes > 0) & (sizes < min_size)
    a = lut[ea]
    b = lut[eb]
    m = a != b
    INF = 2 * K
    biased = torch.full((K,), INF, dtype=torch.int64, device=lut.device)
    # both orientations; non-small neighbours sort first via the +K bias
    for src, dst in ((a, b), (b, a)):
        use = m & small[src]
        val = dst + torch.where(small[dst], K, 0)
        biased.scatter_reduce_(0, src[use], val[use], "amin")
    has_large = biased < K
    tgt = torch.where(has_large, biased, biased - K)
    tgt_safe = tgt.clamp(0, K - 1)
    adopt = small & (biased < INF) & ((tgt < iota) | has_large)
    if capped:
        adopt &= (sizes + sizes[tgt_safe]) <= max_size
    adopt &= ~adopt[tgt_safe]               # one-hop matching
    step = torch.where(adopt, tgt_safe, iota)
    return step[lut], bool(adopt.any())


def _merge_lut_loop(ea, eb, sizes0, min_size: int, max_size: int, K: int,
                    max_iters: int) -> torch.Tensor:
    """Capped sweeps to their fixpoint, then uncapped ones when a
    sub-minimum segment remains (reference ``_merge_lut_loop``)."""
    lut = torch.arange(K, dtype=torch.int64, device=sizes0.device)

    def phase(lut, capped):
        for _ in range(max_iters):
            lut, changed = _sweep(ea, eb, lut, sizes0, min_size, max_size,
                                  K, capped)
            telemetry.count("merge.sweeps")  # each ends in a host sync
            if not changed:
                break
        return lut

    lut = phase(lut, True)
    sizes = torch.zeros(K, dtype=torch.int64,
                        device=lut.device).index_add_(0, lut, sizes0)
    if bool(((sizes > 0) & (sizes < min_size)).any()):
        lut = phase(lut, False)
    return lut


def _merge_final_lut(lut: torch.Tensor, sizes0: torch.Tensor, K: int
                     ) -> Tuple[torch.Tensor, int]:
    """Merge lut -> (dense final lut, K'): classes numbered by their
    minimum member id, i.e. by raster-order first occurrence."""
    iota = torch.arange(K, dtype=torch.int64, device=lut.device)
    sizes = torch.zeros(K, dtype=torch.int64,
                        device=lut.device).index_add_(0, lut, sizes0)
    used = sizes > 0
    rep_min = torch.full((K,), K, dtype=torch.int64, device=lut.device)
    rep_min.scatter_reduce_(0, lut, iota, "amin")
    present = torch.zeros(K + 1, dtype=torch.bool, device=lut.device)
    present[torch.where(used, rep_min, K)] = True
    rank = torch.cumsum(present[:K].to(torch.int64), 0) - 1
    dense_of_rep = rank[rep_min.clamp(0, K - 1)]
    return dense_of_rep[lut], int(used.sum())


def merge_small_device(labels: torch.Tensor, num_labels: int, min_size: int,
                       max_size: int, max_iters: int = 512
                       ) -> Tuple[torch.Tensor, int]:
    """Small-segment merge over dense labels (0..K-1, -1 invalid) ->
    (dense int32 labels, K')."""
    K = max(int(num_labels), 1)
    lab = labels.reshape(-1).long()
    ok = lab >= 0
    sizes0 = torch.bincount(lab[ok], minlength=K)
    ea, eb = label_edges(labels, K)
    lut = _merge_lut_loop(ea, eb, sizes0, int(min_size), int(max_size), K,
                          max_iters)
    final, k = _merge_final_lut(lut, sizes0, K)
    out = torch.where(ok, final[lab.clamp(0, K - 1)], -1)
    return out.to(torch.int32).view(labels.shape), k
