// SLIC k-means passes on Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces no Pallas kernel: obia_tpu/ops/slic.py's k-means loop is plain
// jnp, which XLA fuses on the TPU. The port first ran the same loop as
// PyTorch elementwise ops: ~36 launches for each of the 9 candidate offsets
// of an assignment and ~15 a centre update, ~3,800 launches a SLIC call, each
// reading and writing 0.4-1.2 GB at 100 MP, and a 4.8 GB float64 row table
// an update. That loop (stage slic.iterate) took 1,276-1,279 ms on the 100 MP
// north-star scene and 54-110 ms a 1024^2 tile, where launches bound it.
//
// One launch is one pass over the pixels of an (h, w) block whose first pixel
// is (oy, ox) of an H x W image. For each pixel it does what
// ops/slic.slic_assign_reference (the plain twin) does: among the 9 clamped
// grid neighbours of its own cell (row cell min(y gh / H, gh - 1), column
// cell likewise, in global coordinates, so a block of a sharded image needs
// no halo), in the twin's offset order, the centre with the least D^2 on a
// strict <, so the first of equal distances wins; -1 where `valid` is false
// or no D^2 compares below +inf. As the caller asks, it writes the int64
// labels, and/or adds each assigned pixel's C channels, its row, its column
// and 1 to its centre's float64 sums, (K, C + 3), as
// ops/slic.slic_update_sums64 does.
//
// Design. A block of 8 warps owns a tile of TH x TW pixels (TW a multiple of
// 32); its warps take the tile's row segments of 32 pixels in turn, a lane a
// pixel, so a warp's loads and label stores are contiguous. The tile lies in
// a few grid cells: the block loads the centres of those cells and of the
// ring around them (the window) into shared memory once, with each of its
// rows' and columns' cell. A warp whose pixels of a segment all take one
// centre (the common case: a cell is ~19 px wide on a 1024^2 tile, ~183 px on
// the 100 MP scene) adds them into registers, and adds the warp's total to
// the block's shared float64 bins only when its centre changes; a segment
// whose pixels take several centres is reduced by a segmented scan over its
// runs of equal centres, each run's total added once. At its end the block
// adds each non-empty bin to the global sums with one atomicAdd a value, so
// a pass at 100 MP makes a few million global atomics, not 600 M. The wrapper
// (ops/slic_kernel.tile_plan) picks the tallest tile whose window fits the
// shared memory a block takes without opting in; where none does (very many
// channels on a very fine grid) the block reads the centres and adds the sums
// in global memory directly.
//
// Arithmetic, bitwise the twin's given the same centres: D^2 is formed with
// __fsub_rn, __fmul_rn and __fadd_rn (nvcc would contract a*b + c into an FMA,
// which rounds once) in the twin's order:
//   d_color = ((x0 - c0)^2 + (x1 - c1)^2) + ...,
//   dy = (y - cy) * sy, dx = (x - cx) * sx, d_sp = dy dy + dx dx
//     (sy = sx = 1 without spacing, which is exact),
//   d = d_color + ratio d_sp, or SLICO's d_color inv_k + d_sp (1 / step^2),
// each scalar rounded to float32 as PyTorch rounds it. The sums are float64,
// as the twin's: the atomics add in another order than the twin's
// index_add_, which moves a sum by a few float64 ulps at most and its
// float32 rounding almost never. As in the twin, an unassigned pixel with a
// non-finite channel makes centre 0's sum of that channel NaN (the twin
// multiplies such a pixel's row by 0 and adds it to row 0).
//
// What bounds it on Hopper: bytes. A pass reads the C float32 channels and
// the bool mask once, 13 B/px at C = 3 (1.3 GB, 0.39 ms at 100 MP at 3.35
// TB/s), and a pass that writes labels 8 B/px more.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SLIC_WARPS 8
#define SLIC_THREADS (32 * SLIC_WARPS)
#define SLIC_MAX_TH 32           // tile rows (the wrapper's TILES)
#define SLIC_MAX_TW 128          // tile columns, a multiple of 32
#define SLIC_SMEM_LIMIT 47104    // dynamic shared bytes a block (48 KB less
                                 // the cell tables, without opting in)
#define SLIC_FULL 0xffffffffu

struct SlicGeom {
    long long h, w;    // the block's rows and columns
    long long oy, ox;  // its first pixel's row and column in the image
    long long H, W;    // the image's rows and columns
    int gh, gw;        // the centre grid
    int C;             // channels
    int th, tw;        // a tile's rows and columns
    int tiles_x;       // tiles along the block's width
};

struct SlicDist {
    float ratio;   // (compactness / step)^2, the plain distance
    float inv_s2;  // 1 / step^2, SLICO's
    float sy, sx;  // the spacing, 1 where none is given
};

// The twin's clamp(g * n // N, 0, n - 1) for a global row or column g.
__device__ __forceinline__ int slic_cell(long long g, int n, long long N) {
    const long long c = g * n / N;
    return (int)(c < 0 ? 0 : (c < n - 1 ? c : n - 1));
}

// The best of the 9 candidates of a pixel at (yy, xx) in cell (rc, cc):
// its slot in the window (-1 where none), its global label in `kid`.
// CT > 0: the CT channels in v; CT == 0: C channels read from px.
template <int CT>
__device__ __forceinline__ int slic_best(const float* v, const float* px,
                                         int C, float yy, float xx, int rc,
                                         int cc, int gh, int gw, int r0,
                                         int c0, int nc, const float* ctr,
                                         const float* inv, SlicDist dist,
                                         long long& kid) {
    const int NF = C + 2;
    float best = INFINITY;
    int slot = -1;
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
        const int ri = min(max(rc + di, 0), gh - 1);
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
            const int ci = min(max(cc + dj, 0), gw - 1);
            const int s = (ri - r0) * nc + (ci - c0);
            const float* c = ctr + (size_t)s * NF;
            float dc = 0.0f;
            if constexpr (CT > 0) {
#pragma unroll
                for (int k = 0; k < CT; ++k) {
                    const float t = __fsub_rn(v[k], c[k]);
                    dc = k == 0 ? __fmul_rn(t, t)
                                : __fadd_rn(dc, __fmul_rn(t, t));
                }
            } else {
                for (int k = 0; k < C; ++k) {
                    const float t = __fsub_rn(px[k], c[k]);
                    dc = k == 0 ? __fmul_rn(t, t)
                                : __fadd_rn(dc, __fmul_rn(t, t));
                }
            }
            const float dy = __fmul_rn(__fsub_rn(yy, c[C]), dist.sy);
            const float dx = __fmul_rn(__fsub_rn(xx, c[C + 1]), dist.sx);
            const float dsp = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
            const float d =
                inv != nullptr
                    ? __fadd_rn(__fmul_rn(dc, inv[s]),
                                __fmul_rn(dsp, dist.inv_s2))
                    : __fadd_rn(dc, __fmul_rn(dist.ratio, dsp));
            if (d < best) {
                best = d;
                slot = s;
                kid = (long long)ri * gw + ci;
            }
        }
    }
    return slot;
}

// Adds the warp's register sums (every lane's, warp-uniform bin `cur`) to
// the bin and clears them.
template <int NQ>
__device__ __forceinline__ void slic_flush(double (&acc)[NQ], int cur,
                                           double* bins, int lane) {
    if (cur < 0) return;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        double t = acc[q];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(SLIC_FULL, t, d);
        if (lane == 0) atomicAdd(&bins[(size_t)cur * NQ + q], t);
        acc[q] = 0.0;
    }
}

// Adds a segment's pixels to their bins (`key`, -1 adds nothing): a
// segmented scan over the runs of equal keys among consecutive lanes, each
// run's last lane adding its run's total. NQT > 0: NQT values, else nq.
template <int NQT, class Value>
__device__ __forceinline__ void slic_runs(int key, Value value, int nq,
                                          double* bins, int lane) {
    const int NQ = NQT > 0 ? NQT : nq;
    const int up = __shfl_up_sync(SLIC_FULL, key, 1);
    const int down = __shfl_down_sync(SLIC_FULL, key, 1);
    const unsigned heads = __ballot_sync(SLIC_FULL, lane == 0 || up != key);
    const int start = 31 - __clz(heads & (SLIC_FULL >> (31 - lane)));
    const bool tail = key >= 0 && (lane == 31 || down != key);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        double t = key >= 0 ? value(q) : 0.0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const double u = __shfl_up_sync(SLIC_FULL, t, d);
            if (lane - d >= start) t += u;
        }
        if (tail) atomicAdd(&bins[(size_t)key * NQ + q], t);
    }
}

template <int CT, bool SMEM>
__global__ void __launch_bounds__(SLIC_THREADS)
slic_pass_kernel(const float* __restrict__ img,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ centers,
                 const float* __restrict__ inv_dc, SlicGeom g, SlicDist dist,
                 int64_t* __restrict__ labels, double* __restrict__ sums) {
    extern __shared__ double smem[];
    __shared__ int rcell[SLIC_MAX_TH], ccell[SLIC_MAX_TW];
    const int C = CT > 0 ? CT : g.C;
    const int NF = C + 2, NQ = C + 3;
    const long long y0 = (long long)(blockIdx.x / g.tiles_x) * g.th;
    const long long x0 = (long long)(blockIdx.x % g.tiles_x) * g.tw;
    const int nrow = (int)min((long long)g.th, g.h - y0);
    const int ncol = (int)min((long long)g.tw, g.w - x0);
    for (int i = threadIdx.x; i < nrow; i += SLIC_THREADS)
        rcell[i] = slic_cell(g.oy + y0 + i, g.gh, g.H);
    for (int i = threadIdx.x; i < ncol; i += SLIC_THREADS)
        ccell[i] = slic_cell(g.ox + x0 + i, g.gw, g.W);
    __syncthreads();

    // The window: the tile's cells and the ring around them (the whole grid
    // in global memory without SMEM).
    int r0 = 0, c0 = 0, nr = g.gh, nc = g.gw;
    if (SMEM) {
        r0 = max(rcell[0] - 1, 0);
        nr = min(rcell[nrow - 1] + 1, g.gh - 1) - r0 + 1;
        c0 = max(ccell[0] - 1, 0);
        nc = min(ccell[ncol - 1] + 1, g.gw - 1) - c0 + 1;
    }
    double* bins = sums;
    const float* ctr = centers;
    const float* inv = inv_dc;
    if (SMEM) {
        const int nwin = nr * nc;
        float* fs = (float*)(smem + (sums != nullptr ? (size_t)nwin * NQ : 0));
        for (int i = threadIdx.x; i < nwin * NF; i += SLIC_THREADS) {
            const int s = i / NF, f = i - s * NF;
            fs[i] = centers[((size_t)(r0 + s / nc) * g.gw + c0 + s % nc) * NF
                            + f];
        }
        if (inv_dc != nullptr)
            for (int s = threadIdx.x; s < nwin; s += SLIC_THREADS)
                fs[nwin * NF + s] =
                    inv_dc[(size_t)(r0 + s / nc) * g.gw + c0 + s % nc];
        if (sums != nullptr) {
            for (int i = threadIdx.x; i < nwin * NQ; i += SLIC_THREADS)
                smem[i] = 0.0;
            bins = smem;
        }
        ctr = fs;
        inv = inv_dc != nullptr ? fs + nwin * NF : nullptr;
        __syncthreads();
    }

    const int lane = threadIdx.x & 31;
    const int segs = g.tw >> 5;
    const int items = nrow * segs;
    double acc[CT > 0 ? CT + 3 : 1];
#pragma unroll
    for (int q = 0; q < (CT > 0 ? CT + 3 : 1); ++q) acc[q] = 0.0;
    int cur = -1;  // the bin acc holds, the same in every lane
    for (int it = threadIdx.x >> 5; it < items; it += SLIC_WARPS) {
        const int iy = it / segs, ix = (it - iy * segs) * 32 + lane;
        const bool inside = ix < ncol;
        const long long p = (y0 + iy) * g.w + x0 + ix;
        const float* px = img + p * C;
        const float yy = (float)(g.oy + y0 + iy), xx = (float)(g.ox + x0 + ix);
        float v[CT > 0 ? CT : 1];
        int slot = -1;
        if (inside) {
            if constexpr (CT > 0) {
#pragma unroll
                for (int k = 0; k < CT; ++k) v[k] = px[k];
            }
            long long kid = -1;
            if (valid[p])
                slot = slic_best<CT>(v, px, C, yy, xx, rcell[iy], ccell[ix],
                                     g.gh, g.gw, r0, c0, nc, ctr, inv, dist,
                                     kid);
            if (labels != nullptr) labels[p] = kid;
            if (sums != nullptr && slot < 0)
                for (int k = 0; k < C; ++k) {
                    const float x = CT > 0 ? v[k < CT ? k : 0] : px[k];
                    if (!isfinite(x)) atomicAdd(&sums[k], (double)NAN);
                }
        }
        if (sums == nullptr) continue;
        auto value = [&](int q) -> double {
            if (q < C) {
                if constexpr (CT > 0) return (double)v[q < CT ? q : 0];
                else return (double)px[q];
            }
            return q == C ? (double)yy : q == C + 1 ? (double)xx : 1.0;
        };
        const unsigned any = __ballot_sync(SLIC_FULL, slot >= 0);
        if (any == 0) continue;
        if constexpr (CT > 0) {
            const int k0 = __shfl_sync(SLIC_FULL, slot, __ffs(any) - 1);
            if (__all_sync(SLIC_FULL, slot < 0 || slot == k0)) {
                if (k0 != cur) {
                    slic_flush<CT + 3>(acc, cur, bins, lane);
                    cur = k0;
                }
                if (slot >= 0) {
#pragma unroll
                    for (int q = 0; q < CT + 3; ++q) acc[q] += value(q);
                }
                continue;
            }
        }
        slic_runs<(CT > 0 ? CT + 3 : 0)>(slot, value, NQ, bins, lane);
    }
    if (sums == nullptr) return;
    if constexpr (CT > 0) slic_flush<CT + 3>(acc, cur, bins, lane);
    if (SMEM) {
        __syncthreads();
        const int nwin = nr * nc;
        for (int e = threadIdx.x; e < nwin * NQ; e += SLIC_THREADS) {
            const int s = e / NQ;
            if (bins[(size_t)s * NQ + NQ - 1] == 0.0) continue;  // no pixel
            const long long kid = (long long)(r0 + s / nc) * g.gw + c0 + s % nc;
            atomicAdd(&sums[kid * NQ + (e - s * NQ)], bins[e]);
        }
    }
}

// Dynamic shared bytes of a window of nwin centres.
static size_t slic_smem(long long nwin, int C, bool sums, bool slico) {
    return (size_t)nwin * ((sums ? (C + 3) * sizeof(double) : 0) +
                           (C + 2) * sizeof(float) +
                           (slico ? sizeof(float) : 0));
}

template <int CT>
struct SlicLaunch {
    static int run(const float* img, const uint8_t* valid,
                   const float* centers, const float* inv, SlicGeom g,
                   SlicDist dist, int nr_cap, int nc_cap, int64_t* labels,
                   double* sums, cudaStream_t stream) {
        const long long tiles_y = (g.h + g.th - 1) / g.th;
        const long long tiles_x = (g.w + g.tw - 1) / g.tw;
        if (tiles_y * tiles_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        g.tiles_x = (int)tiles_x;
        const unsigned blocks = (unsigned)(tiles_y * tiles_x);
        if (nr_cap > 0) {
            const size_t smem = slic_smem((long long)nr_cap * nc_cap, g.C,
                                          sums != nullptr, inv != nullptr);
            if (smem > SLIC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
            slic_pass_kernel<CT, true><<<blocks, SLIC_THREADS, smem, stream>>>(
                img, valid, centers, inv, g, dist, labels, sums);
        } else {
            slic_pass_kernel<CT, false><<<blocks, SLIC_THREADS, 0, stream>>>(
                img, valid, centers, inv, g, dist, labels, sums);
        }
        return (int)cudaGetLastError();
    }
};

// Launches one pass on `stream` and returns cudaGetLastError(); never
// synchronises. img: (h, w, C) float32; valid: (h, w) bool; centers: (gh,
// gw, C + 2) float32 (channels, row, column); inv_max_dc: (gh, gw) float32
// for SLICO, else null; all contiguous. The block's first pixel is (oy, ox)
// of an H x W image. ratio, inv_s2 (1 / step^2), sy, sx: float32 as the twin
// rounds them. A tile is th x tw pixels (th <= 32; tw 32, 64 or 128); the
// window is at most nr_cap x nc_cap centres in shared memory, or the whole
// grid in global memory where nr_cap is 0. labels: (h, w) int64 output or
// null; sums: (gh gw, C + 3) float64, zeroed by the caller, or null; not
// both null.
extern "C" int obia_slic_pass(const void* img, const void* valid,
                              const void* centers, const void* inv_max_dc,
                              int C, long long h, long long w, long long oy,
                              long long ox, long long H, long long W, int gh,
                              int gw, float ratio, float inv_s2, float sy,
                              float sx, int th, int tw, int nr_cap,
                              int nc_cap, void* labels, void* sums,
                              void* stream) {
    if (C < 1 || h < 1 || w < 1 || H < 1 || W < 1 || oy < 0 || ox < 0 ||
        gh < 1 || gw < 1 || th < 1 || th > SLIC_MAX_TH || tw < 32 ||
        tw > SLIC_MAX_TW || tw % 32 != 0 || nr_cap < 0 || nc_cap < 0 ||
        (nr_cap > 0) != (nc_cap > 0) || (labels == nullptr && sums == nullptr))
        return (int)cudaErrorInvalidValue;
    SlicGeom g{h, w, oy, ox, H, W, gh, gw, C, th, tw, 0};
    const SlicDist dist{ratio, inv_s2, sy, sx};
    const float* a = (const float*)img;
    const uint8_t* m = (const uint8_t*)valid;
    const float* c = (const float*)centers;
    const float* inv = (const float*)inv_max_dc;
    int64_t* lab = (int64_t*)labels;
    double* s = (double*)sums;
    cudaStream_t st = (cudaStream_t)stream;
    // C = 3 (Lab, every cell's scene) holds its channels in registers; any
    // other C reads them through the generic path.
    if (C == 3)
        return SlicLaunch<3>::run(a, m, c, inv, g, dist, nr_cap, nc_cap, lab, s, st);
    return SlicLaunch<0>::run(a, m, c, inv, g, dist, nr_cap, nc_cap, lab, s, st);
}
