// Quickshift window scans on Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the two TPU kernels of obia_tpu/ops/quickshift_pallas.py:
//   * _density_kernel (launched by _density_call): the Parzen density
//       rho = 1 + sum exp(-d2 * inv2k2)
//     over every offset (dy, dx) of the (2r+1)^2 window but (0, 0), with
//       d2 = sum_c (img_c[p] - img_c[p + (dy, dx)])^2 + dy^2 + dx^2;
//   * _parent_kernel (launched by _parent_call): for every pixel, the window
//     neighbour with strictly higher rho and d2 <= max_d2 that has the least
//     d2, ties to the first in row-major (dy, dx) order; it writes that d2
//     (inf when there is none) and the linear offset dy * W + dx (0 then).
// Neighbours outside the image and non-finite d2 (a NaN or inf pixel) drop
// out, as the +inf padding and the isfinite mask drop them in the JAX code.
//
// Design. A block owns a TH x (TX P) output tile and loads its halo once
// into shared memory, channel-planar: (planes, TH + 2R, TX P + 2R) floats,
// +inf outside the image in the image planes and -inf in the parent's rho
// plane. That is the twin's padding, so an offset that leaves the image
// drops out by the same tests that drop a NaN pixel, and no offset is ever
// tested against a bound. Each thread owns a strip of P = 5 pixels along its
// row; TX threads (32, 16, 8 or 4) span a row of the tile, so a full-width
// warp holds 160 pixels of one row. For each window row a thread streams the
// halo columns x - R .. x + P - 1 + R through a ring of P register columns
// (QsRing): one load of a neighbour's values serves P pixel-offsets, and
// off2, the self test and the loop limits are worked out once an offset for
// all P pixels, whose five chains the compiler interleaves (no branch in
// the loop body). P is odd, so 32 lanes of a row, P words apart, hit 32
// banks. The loop limits are clipped once a strip to the rows and columns
// that reach the image: the whole window inside it, fewer offsets at an
// edge. The parent scan visits only the max_dist disk: d2 = fadd_rn(colour,
// off2) with the colour sum >= 0 and off2 exact, so d2 >= off2 and an
// offset with dy^2 + dx^2 > max_d2 can never pass d2 <= max_d2. Its halo
// radius is therefore rp = min(r, floor(max_dist)) (the wrapper passes rp
// as `r`), and row dy spans |dx| <= the largest w with dy^2 + w^2 <=
// max_d2. The wrapper (ops/quickshift_kernel.tile_shape) picks TX and TH:
// of the shapes whose halo fits, the one that loads the fewest halo floats
// an output pixel. A narrow tile lets a large radius's halo fit the shared
// memory of one block; the launcher takes the shape as given.
//
// Arithmetic: for each pixel, d2 is formed channel by channel and then
// dy^2 + dx^2 is added, as obia_tpu/ops/quickshift_pallas._d2_at does, with
// __fsub_rn, __fmul_rn and __fadd_rn so nvcc contracts nothing into an FMA.
// The density uses expf (not __expf) and accumulates from 1 in row-major
// (dy, dx) order; the parent updates on strict <, in the same order. Given
// the same rho, the parent scan is bitwise the plain torch twin's.
//
// What bounds it on Hopper: instruction issue. The density evaluates
// (2r+1)^2 - 1 offsets a pixel, each 3C + 11 issued instructions (d2, the
// scale, the NaN guard, expf's range reduction around one MUFU.EX2, the
// sum); its bound counts 3C + 4 float32 operations over 67 TFLOP/s and one
// exponential over the SFU's 16 a clock per SM (4.18 T/s at 1.98 GHz): at
// C = 3 the SFU term is the larger, and issue, at 20 instructions, is 4x
// it. The parent evaluates the offsets of the disk (316 of the 960 at
// r = 15, max_dist = 10) at 3C + 4 instructions (d2, two compares, two
// selects); its bound counts 3C + 4 float32 operations each. Channels above
// 8 take a generic path that reads both pixels from shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#define QS_P 5                   // pixels a thread: a strip along its row
#define QS_MAX_TX 32             // most threads along a row (blockDim.x)
#define QS_MAX_TH 16             // tallest tile (blockDim.y)
#define QS_MAX_DEVICES 64

struct QsTile {
    int r;      // halo radius
    int tx;     // threads along a row (blockDim.x)
    int th;     // tile height (blockDim.y)
    int tw;     // tile width in pixels, tx * P
    int hw;     // halo width = tw + 2r
    int plane;  // hw * (th + 2r), floats in one halo plane
};

// Cooperative halo load of `planes` planes of `src` ((planes, H, W) float32)
// into `dst` ((planes, th + 2r, hw)); outside the image holds `fill`.
__device__ __forceinline__ void qs_load_halo(float* dst,
                                             const float* __restrict__ src,
                                             int planes, long long H,
                                             long long W, QsTile t,
                                             long long y0, long long x0,
                                             float fill) {
    const int tid = threadIdx.y * t.tx + threadIdx.x;
    const int nthreads = t.tx * t.th;
    const int n = planes * t.plane;
    for (int i = tid; i < n; i += nthreads) {
        const int c = i / t.plane;
        const int rem = i - c * t.plane;
        const int hy = rem / t.hw;
        const int hx = rem - hy * t.hw;
        const long long y = y0 - t.r + hy, x = x0 - t.r + hx;
        float v = fill;
        if (y >= 0 && y < H && x >= 0 && x < W) v = src[(c * H + y) * W + x];
        dst[i] = v;
    }
}

// One thread's strip: P pixels of row y from column x, in the tile whose
// first pixel is (y0, x0).
struct QsStrip {
    long long y0, x0, y, x;
    const float* ctr;  // pixel j's value v in the halo: ctr[v * plane + j]
    int dy0, dy1;      // window rows inside the image
    int lo, hi;        // window columns inside it for some pixel of the strip
};

__device__ __forceinline__ QsStrip qs_strip(const float* smem, long long H,
                                            long long W, QsTile t,
                                            int tiles_x) {
    QsStrip s;
    s.y0 = (long long)(blockIdx.x / tiles_x) * t.th;
    s.x0 = (long long)(blockIdx.x % tiles_x) * t.tw;
    s.y = s.y0 + threadIdx.y;
    s.x = s.x0 + threadIdx.x * QS_P;
    s.ctr = smem + (threadIdx.y + t.r) * t.hw + threadIdx.x * QS_P + t.r;
    const long long r = t.r;
    s.dy0 = (int)max(-r, -s.y);
    s.dy1 = (int)min(r, H - 1 - s.y);
    s.lo = (int)max(-r, -(s.x + QS_P - 1));
    s.hi = (int)min(r, W - 1 - s.x);
    return s;
}

// A ring of P register columns of NV values over one halo row (value v of
// the column at offset dx from pixel 0 at row[v * plane + dx]). In a run of
// P steps, at step k (a constant once the loop is unrolled) load(k, dx)
// brings in the column that pixel P - 1 needs at offset dx, and at(k, j) is
// pixel j's neighbour there.
template <int NV>
struct QsRing {
    float v[QS_P][NV > 0 ? NV : 1];
    const float* row;
    int plane;

    __device__ __forceinline__ QsRing(const float* row_, int plane_, int lo)
        : row(row_), plane(plane_) {
#pragma unroll
        for (int k = 0; k < QS_P - 1; ++k)
#pragma unroll
            for (int c = 0; c < NV; ++c) v[k][c] = row[c * plane + lo + k];
    }
    __device__ __forceinline__ void load(int k, int dx) {
#pragma unroll
        for (int c = 0; c < NV; ++c)
            v[(k + QS_P - 1) % QS_P][c] = row[c * plane + dx + QS_P - 1];
    }
    __device__ __forceinline__ const float* at(int k, int j) const {
        return v[(k + j) % QS_P];
    }
};

// sum_c (a_c - b_c)^2 + off2, channel by channel in order, no FMA
// contraction. CT > 0: CT channels in registers; CT == 0: C channels in
// shared memory, `plane` floats apart.
template <int CT>
__device__ __forceinline__ float qs_d2(const float* a, const float* b, int C,
                                       int plane, float off2) {
    float d2 = 0.0f;
    if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
            const float t = __fsub_rn(a[c], b[c]);
            d2 = c == 0 ? __fmul_rn(t, t) : __fadd_rn(d2, __fmul_rn(t, t));
        }
    } else {
        for (int c = 0; c < C; ++c) {
            const float t = __fsub_rn(a[c * plane], b[c * plane]);
            d2 = c == 0 ? __fmul_rn(t, t) : __fadd_rn(d2, __fmul_rn(t, t));
        }
    }
    return __fadd_rn(d2, off2);
}

// The strip's centre channels in registers (CT > 0).
template <int CT>
__device__ __forceinline__ void qs_centre(float (&ctr)[QS_P][CT > 0 ? CT : 1],
                                          const QsStrip& s, int plane) {
    if constexpr (CT > 0) {
#pragma unroll
        for (int j = 0; j < QS_P; ++j)
#pragma unroll
            for (int c = 0; c < CT; ++c)
                ctr[j][c] = s.ctr[c * plane + j];
    }
}

template <class T>
__device__ __forceinline__ void qs_store(T* __restrict__ out,
                                         const T (&v)[QS_P], const QsStrip& s,
                                         long long W) {
#pragma unroll
    for (int j = 0; j < QS_P; ++j)
        if (s.x + j < W) out[s.y * W + s.x + j] = v[j];
}

// The largest w <= rp with dy^2 + w^2 <= max_d2, in integers against the
// float max_d2 (0 when none is).
__device__ __forceinline__ int qs_disk_width(int dy, int rp, float max_d2) {
    int w = rp;
    while (w > 0 && (float)(dy * dy + w * w) > max_d2) --w;
    return w;
}

template <int CT>
__global__ void __launch_bounds__(QS_MAX_TX * QS_MAX_TH)
qs_density_kernel(const float* __restrict__ img, int C, long long H,
                  long long W, QsTile t, int tiles_x, float inv2k2,
                  float* __restrict__ rho) {
    extern __shared__ float smem[];
    const QsStrip s = qs_strip(smem, H, W, t, tiles_x);
    qs_load_halo(smem, img, C, H, W, t, s.y0, s.x0, INFINITY);
    __syncthreads();
    if (s.y >= H || s.x >= W) return;
    float ctr[QS_P][CT > 0 ? CT : 1];
    qs_centre<CT>(ctr, s, t.plane);
    float acc[QS_P];
#pragma unroll
    for (int j = 0; j < QS_P; ++j) acc[j] = 1.0f;
    const int n = s.hi - s.lo + 1;
    for (int dy = s.dy0; dy <= s.dy1; ++dy) {
        const float* row = s.ctr + dy * t.hw;
        const int dy2 = dy * dy;
        QsRing<CT> ring(row, t.plane, s.lo);
        for (int s0 = 0; s0 < n; s0 += QS_P) {
#pragma unroll
            for (int k = 0; k < QS_P; ++k) {
                if (s0 + k >= n) break;
                const int dx = s.lo + s0 + k;
                ring.load(k, dx);
                if (dy == 0 && dx == 0) continue;  // the centre itself
                const float off2 = (float)(dy2 + dx * dx);
#pragma unroll
                for (int j = 0; j < QS_P; ++j) {
                    float d2;
                    if constexpr (CT > 0)
                        d2 = qs_d2<CT>(ctr[j], ring.at(k, j), C, 1, off2);
                    else
                        d2 = qs_d2<0>(s.ctr + j, row + dx + j, C, t.plane,
                                      off2);
                    // The twin adds where(isfinite(d2), exp(-d2 inv2k2), 0).
                    // d2 is finite, +inf or NaN; +inf and NaN make the
                    // argument -inf or NaN (inv2k2 > 0, or 0 for a huge
                    // kernel_size), and fmaxf(NaN, -inf) is -inf, so both
                    // add expf(-inf) = 0, with no test and no branch (a
                    // branch around each pixel's expf would keep the P
                    // pixels from interleaving).
                    acc[j] = __fadd_rn(
                        acc[j],
                        expf(fmaxf(__fmul_rn(-d2, inv2k2), -INFINITY)));
                }
            }
        }
    }
    qs_store(rho, acc, s, W);
}

template <int CT>
__global__ void __launch_bounds__(QS_MAX_TX * QS_MAX_TH)
qs_parent_kernel(const float* __restrict__ img, const float* __restrict__ rho,
                 int C, long long H, long long W, QsTile t, int tiles_x,
                 float max_d2, float* __restrict__ best_d2,
                 int32_t* __restrict__ best_doff) {
    extern __shared__ float smem[];
    const QsStrip s = qs_strip(smem, H, W, t, tiles_x);
    qs_load_halo(smem, img, C, H, W, t, s.y0, s.x0, INFINITY);
    qs_load_halo(smem + C * t.plane, rho, 1, H, W, t, s.y0, s.x0, -INFINITY);
    __syncthreads();
    if (s.y >= H || s.x >= W) return;
    float ctr[QS_P][CT > 0 ? CT : 1];
    qs_centre<CT>(ctr, s, t.plane);
    // lim[j] folds the twin's d2 <= max_d2 && d2 < best: it starts at lim0,
    // the float after max_d2, so d2 < lim is d2 <= max_d2, and each update
    // sets it to d2 (<= max_d2 < lim0). NaN fails the compare, and +inf
    // fails it too (lim <= inf), as +inf fails d2 < best in the twin, whose
    // best starts at inf. So lim[j] < lim0 exactly when a parent was found.
    float rho_c[QS_P], lim[QS_P];
    int32_t doff[QS_P];
    const float lim0 = nextafterf(max_d2, INFINITY);
#pragma unroll
    for (int j = 0; j < QS_P; ++j) {
        rho_c[j] = s.ctr[C * t.plane + j];
        lim[j] = lim0;
        doff[j] = 0;
    }
    // t.r is rp, so [dy0, dy1] holds only rows of the disk. The centre
    // itself needs no test: its rho is not higher than its own.
    for (int dy = s.dy0; dy <= s.dy1; ++dy) {
        const int w = qs_disk_width(dy, t.r, max_d2);
        const int lo = max(s.lo, -w), n = min(s.hi, w) - lo + 1;
        const float* row = s.ctr + dy * t.hw;
        const int dy2 = dy * dy, rowoff = (int)(dy * W);
        QsRing<(CT > 0 ? CT + 1 : 0)> ring(row, t.plane, lo);
        for (int s0 = 0; s0 < n; s0 += QS_P) {
#pragma unroll
            for (int k = 0; k < QS_P; ++k) {
                if (s0 + k >= n) break;
                const int dx = lo + s0 + k;
                ring.load(k, dx);
                const float off2 = (float)(dy2 + dx * dx);
#pragma unroll
                for (int j = 0; j < QS_P; ++j) {
                    float d2, nb_rho;
                    if constexpr (CT > 0) {
                        const float* nb = ring.at(k, j);
                        d2 = qs_d2<CT>(ctr[j], nb, C, 1, off2);
                        nb_rho = nb[CT];
                    } else {
                        d2 = qs_d2<0>(s.ctr + j, row + dx + j, C, t.plane,
                                      off2);
                        nb_rho = row[C * t.plane + dx + j];
                    }
                    if (nb_rho > rho_c[j] && d2 < lim[j]) {
                        lim[j] = d2;
                        doff[j] = rowoff + dx;
                    }
                }
            }
        }
    }
    float best[QS_P];
#pragma unroll
    for (int j = 0; j < QS_P; ++j) best[j] = lim[j] < lim0 ? lim[j] : INFINITY;
    qs_store(best_d2, best, s, W);
    qs_store(best_doff, doff, s, W);
}

static QsTile qs_tile(int r, int tx, int th) {
    QsTile t;
    t.r = r;
    t.tx = tx;
    t.th = th;
    t.tw = tx * QS_P;
    t.hw = t.tw + 2 * r;
    t.plane = t.hw * (th + 2 * r);
    return t;
}

static bool qs_bad(long long C, long long H, long long W, int r, int r_min,
                   int tx, int th) {
    return C < 1 || H < 1 || W < 1 || r < r_min || tx < 1 ||
           tx > QS_MAX_TX || th < 1 || th > QS_MAX_TH;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device unless an earlier launch there already did; `allowed` is the
// kernel's own record of the limit set on each device. Concurrent first
// calls may both set it, to the same effect.
template <class K>
static cudaError_t qs_allow_smem(K kernel, size_t bytes,
                                 std::atomic<int>* allowed) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < QS_MAX_DEVICES &&
        (int)bytes <= allowed[device].load(std::memory_order_relaxed))
        return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && device < QS_MAX_DEVICES)
        allowed[device].store((int)bytes, std::memory_order_relaxed);
    return err;
}

// One scan's launch: its tile, its grid of tiles numbered row-major in one
// dimension, and its dynamic shared memory (`planes` halo planes).
struct QsPlan {
    QsTile t;
    int tiles_x;
    unsigned int blocks;
    size_t smem;

    QsPlan(long long H, long long W, int planes, int r, int tx, int th)
        : t(qs_tile(r, tx, th)) {
        tiles_x = (int)((W + t.tw - 1) / t.tw);
        blocks = (unsigned int)(tiles_x * ((H + th - 1) / th));
        smem = (size_t)planes * t.plane * sizeof(float);
    }
};

template <int CT>
struct QsDensityLaunch {
    static int run(const float* img, int C, long long H, long long W, int r,
                   int tx, int th, float inv2k2, float* rho,
                   cudaStream_t stream) {
        static std::atomic<int> allowed[QS_MAX_DEVICES];
        const QsPlan p(H, W, C, r, tx, th);
        const cudaError_t err =
            qs_allow_smem(qs_density_kernel<CT>, p.smem, allowed);
        if (err != cudaSuccess) return (int)err;
        qs_density_kernel<CT><<<p.blocks, dim3(tx, th), p.smem, stream>>>(
            img, C, H, W, p.t, p.tiles_x, inv2k2, rho);
        return (int)cudaGetLastError();
    }
};

template <int CT>
struct QsParentLaunch {
    static int run(const float* img, const float* rho, int C, long long H,
                   long long W, int rp, int tx, int th, float max_d2,
                   float* best_d2, int32_t* best_doff, cudaStream_t stream) {
        static std::atomic<int> allowed[QS_MAX_DEVICES];
        const QsPlan p(H, W, C + 1, rp, tx, th);
        const cudaError_t err =
            qs_allow_smem(qs_parent_kernel<CT>, p.smem, allowed);
        if (err != cudaSuccess) return (int)err;
        qs_parent_kernel<CT><<<p.blocks, dim3(tx, th), p.smem, stream>>>(
            img, rho, C, H, W, p.t, p.tiles_x, max_d2, best_d2, best_doff);
        return (int)cudaGetLastError();
    }
};

template <int CT>
struct QsAttributes {
    static int run(int parent, int* out) {
        cudaFuncAttributes a;
        const cudaError_t err =
            parent ? cudaFuncGetAttributes(&a, qs_parent_kernel<CT>)
                   : cudaFuncGetAttributes(&a, qs_density_kernel<CT>);
        if (err != cudaSuccess) return (int)err;
        out[0] = a.numRegs;
        out[1] = (int)a.localSizeBytes;
        out[2] = QS_P;
        return 0;
    }
};

// Calls Op<CT>::run(args...) with CT = C for C <= 8, else CT = 0 (generic).
template <template <int> class Op, class... A>
static int qs_dispatch(int C, A... args) {
    switch (C > 8 ? 0 : C) {
        case 1: return Op<1>::run(args...);
        case 2: return Op<2>::run(args...);
        case 3: return Op<3>::run(args...);
        case 4: return Op<4>::run(args...);
        case 5: return Op<5>::run(args...);
        case 6: return Op<6>::run(args...);
        case 7: return Op<7>::run(args...);
        case 8: return Op<8>::run(args...);
        default: return Op<0>::run(args...);
    }
}

// Launches the density scan on `stream` and returns cudaGetLastError().
// img: (C, H, W) float32, already scaled by the ratio; rho: (H, W) float32
// output; r >= 1: window radius; a tile is th x (tx P) pixels, blockDim
// (tx, th), tx <= 32, th <= 16 (the wrapper's tile_shape); inv2k2:
// 1 / (2 kernel_size^2) rounded to float32. Dynamic shared memory:
// C * (th + 2r) * (tx P + 2r) * 4 bytes.
extern "C" int obia_qs_density(const void* img, int C, long long H,
                               long long W, int r, int tx, int th,
                               float inv2k2, void* rho, void* stream) {
    if (qs_bad(C, H, W, r, 1, tx, th)) return (int)cudaErrorInvalidValue;
    return qs_dispatch<QsDensityLaunch>(C, (const float*)img, C, H, W, r, tx,
                                        th, inv2k2, (float*)rho,
                                        (cudaStream_t)stream);
}

// Launches the parent scan on `stream` and returns cudaGetLastError().
// img: (C, H, W) float32 as for the density; rho: (H, W) float32 noised
// density; outputs best_d2 (H, W) float32 and best_doff (H, W) int32;
// max_d2: max_dist^2 rounded to float32; rp >= 0: the disk's radius,
// min(r, floor(sqrt(max_d2))), which is also the halo's; tx, th as for the
// density. Dynamic shared memory: (C + 1) * (th + 2 rp) * (tx P + 2 rp) * 4
// bytes.
extern "C" int obia_qs_parent(const void* img, const void* rho, int C,
                              long long H, long long W, int rp, int tx,
                              int th, float max_d2, void* best_d2,
                              void* best_doff, void* stream) {
    if (qs_bad(C, H, W, rp, 0, tx, th)) return (int)cudaErrorInvalidValue;
    return qs_dispatch<QsParentLaunch>(
        C, (const float*)img, (const float*)rho, C, H, W, rp, tx, th, max_d2,
        (float*)best_d2, (int32_t*)best_doff, (cudaStream_t)stream);
}

// Writes, for the density (parent = 0) or the parent scan at C channels,
// the kernel's registers a thread, its local (spilled) bytes a thread and
// its pixels a thread P to out[0..2]; returns cudaFuncGetAttributes' status.
extern "C" int obia_qs_attributes(int parent, int C, int* out) {
    if (C < 1) return (int)cudaErrorInvalidValue;
    return qs_dispatch<QsAttributes>(C, parent, out);
}
