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
// Design: one thread per output pixel. A block owns a TH x 32 output tile
// (TH chosen by the wrapper so that the halo fits) and loads its halo once
// into shared memory, channel-planar: (C, TH + 2r, 32 + 2r) floats of the
// image, plus the rho halo for the parent scan. Every offset is then read
// from shared memory; a warp covers 32 neighbouring pixels of one row, so
// its reads hit 32 consecutive words (no bank conflicts). The centre pixel's
// channels sit in registers (a template on C for C <= 8; above 8 they are
// read from shared memory). Each thread loops only over the offsets that
// stay inside the image, in row-major order, which is the order the Pallas
// kernel accumulates in.
//
// Arithmetic: d2 is formed channel by channel and then dy^2 + dx^2 is added,
// as obia_tpu/ops/quickshift_pallas._d2_at does, with __fsub_rn, __fmul_rn
// and __fadd_rn so nvcc contracts nothing into an FMA. The density uses
// expf (not __expf) and accumulates in float32. Given the same rho, the
// parent scan is therefore bitwise the plain torch twin's.
//
// What bounds it on Hopper: arithmetic. At r = 15 every pixel evaluates 960
// offsets of ~4C + 10 float operations (the density adds an expf), against
// one read of the image per pixel (the halo re-reads a few times that).
// Fusing the two scans or using TMA for the halo is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QS_TW 32  // tile width: one warp along a row

struct QsTile {
    int r;      // window radius
    int th;     // tile height (blockDim.y)
    int hw;     // halo width = QS_TW + 2r
    int plane;  // hw * (th + 2r), floats in one halo plane
};

// Cooperative halo load of `planes` channel planes of `src` ((planes, H, W)
// float32) into `dst` ((planes, th + 2r, hw)); outside the image holds 0, which
// the scans never read (they bound their offsets to the image).
__device__ __forceinline__ void qs_load_halo(float* dst,
                                             const float* __restrict__ src,
                                             int planes, long long H,
                                             long long W, QsTile t,
                                             long long y0, long long x0) {
    const int tid = threadIdx.y * QS_TW + threadIdx.x;
    const int nthreads = QS_TW * t.th;
    const int n = planes * t.plane;
    for (int i = tid; i < n; i += nthreads) {
        const int c = i / t.plane;
        const int rem = i - c * t.plane;
        const int hy = rem / t.hw;
        const int hx = rem - hy * t.hw;
        const long long y = y0 - t.r + hy, x = x0 - t.r + hx;
        float v = 0.0f;
        if (y >= 0 && y < H && x >= 0 && x < W) v = src[(c * H + y) * W + x];
        dst[i] = v;
    }
}

// sum_c (ctr_c - nb_c)^2 + off2, in channel order, no FMA contraction.
// CT > 0: the centre's channels are in registers (ctr); CT == 0: C channels,
// the centre is read from shared memory at `ci`.
template <int CT>
__device__ __forceinline__ float qs_d2(const float* s, const float* ctr,
                                       int C, int plane, int ci, int ni,
                                       float off2) {
    float d2 = 0.0f;
    if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
            const float t = __fsub_rn(ctr[c], s[c * plane + ni]);
            d2 = c == 0 ? __fmul_rn(t, t) : __fadd_rn(d2, __fmul_rn(t, t));
        }
    } else {
        for (int c = 0; c < C; ++c) {
            const float t = __fsub_rn(s[c * plane + ci], s[c * plane + ni]);
            d2 = c == 0 ? __fmul_rn(t, t) : __fadd_rn(d2, __fmul_rn(t, t));
        }
    }
    return __fadd_rn(d2, off2);
}

template <int CT>
__global__ void qs_density_kernel(const float* __restrict__ img, int C,
                                  long long H, long long W, QsTile t,
                                  int tiles_x, float inv2k2,
                                  float* __restrict__ rho) {
    extern __shared__ float smem[];
    const long long y0 = (long long)(blockIdx.x / tiles_x) * t.th;
    const long long x0 = (long long)(blockIdx.x % tiles_x) * QS_TW;
    qs_load_halo(smem, img, C, H, W, t, y0, x0);
    __syncthreads();

    const long long y = y0 + threadIdx.y, x = x0 + threadIdx.x;
    if (y >= H || x >= W) return;
    const int r = t.r;
    const int ci = (threadIdx.y + r) * t.hw + threadIdx.x + r;
    float ctr[CT > 0 ? CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) ctr[c] = smem[c * t.plane + ci];
    }
    const int dy0 = (int)(y - r < 0 ? -y : -r);
    const int dy1 = (int)(y + r >= H ? H - 1 - y : r);
    const int dx0 = (int)(x - r < 0 ? -x : -r);
    const int dx1 = (int)(x + r >= W ? W - 1 - x : r);
    float acc = 1.0f;
    for (int dy = dy0; dy <= dy1; ++dy) {
        const int row = ci + dy * t.hw;
        for (int dx = dx0; dx <= dx1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            const float d2 = qs_d2<CT>(smem, ctr, C, t.plane, ci, row + dx,
                                       (float)(dy * dy + dx * dx));
            if (isfinite(d2))
                acc = __fadd_rn(acc, expf(__fmul_rn(-d2, inv2k2)));
        }
    }
    rho[y * W + x] = acc;
}

template <int CT>
__global__ void qs_parent_kernel(const float* __restrict__ img,
                                 const float* __restrict__ rho, int C,
                                 long long H, long long W, QsTile t,
                                 int tiles_x, float max_d2,
                                 float* __restrict__ best_d2,
                                 int32_t* __restrict__ best_doff) {
    extern __shared__ float smem[];
    float* srho = smem + C * t.plane;
    const long long y0 = (long long)(blockIdx.x / tiles_x) * t.th;
    const long long x0 = (long long)(blockIdx.x % tiles_x) * QS_TW;
    qs_load_halo(smem, img, C, H, W, t, y0, x0);
    qs_load_halo(srho, rho, 1, H, W, t, y0, x0);
    __syncthreads();

    const long long y = y0 + threadIdx.y, x = x0 + threadIdx.x;
    if (y >= H || x >= W) return;
    const int r = t.r;
    const int ci = (threadIdx.y + r) * t.hw + threadIdx.x + r;
    float ctr[CT > 0 ? CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c) ctr[c] = smem[c * t.plane + ci];
    }
    const float rho_c = srho[ci];
    const int dy0 = (int)(y - r < 0 ? -y : -r);
    const int dy1 = (int)(y + r >= H ? H - 1 - y : r);
    const int dx0 = (int)(x - r < 0 ? -x : -r);
    const int dx1 = (int)(x + r >= W ? W - 1 - x : r);
    float best = INFINITY;
    int doff = 0;
    for (int dy = dy0; dy <= dy1; ++dy) {
        const int row = ci + dy * t.hw;
        for (int dx = dx0; dx <= dx1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            if (!(srho[row + dx] > rho_c)) continue;
            const float d2 = qs_d2<CT>(smem, ctr, C, t.plane, ci, row + dx,
                                       (float)(dy * dy + dx * dx));
            if (d2 <= max_d2 && isfinite(d2) && d2 < best) {
                best = d2;
                doff = (int)(dy * W + dx);
            }
        }
    }
    best_d2[y * W + x] = best;
    best_doff[y * W + x] = doff;
}

static QsTile qs_tile(int r, int th) {
    QsTile t;
    t.r = r;
    t.th = th;
    t.hw = QS_TW + 2 * r;
    t.plane = t.hw * (th + 2 * r);
    return t;
}

static bool qs_bad(long long C, long long H, long long W, int r, int th) {
    return C < 1 || H < 1 || W < 1 || r < 1 || th < 1 || th > 32;
}

// Tiles of QS_TW x th over the raster, numbered row-major in a 1-D grid.
static unsigned int qs_blocks(long long H, long long W, int th,
                              int* tiles_x) {
    *tiles_x = (int)((W + QS_TW - 1) / QS_TW);
    return (unsigned int)(*tiles_x * ((H + th - 1) / th));
}

template <int CT>
static int qs_density_launch(const float* img, int C, long long H,
                             long long W, QsTile t, float inv2k2, float* rho,
                             cudaStream_t stream) {
    const size_t smem = (size_t)C * t.plane * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        qs_density_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int tiles_x;
    const unsigned int blocks = qs_blocks(H, W, t.th, &tiles_x);
    qs_density_kernel<CT><<<blocks, dim3(QS_TW, t.th), smem, stream>>>(
        img, C, H, W, t, tiles_x, inv2k2, rho);
    return (int)cudaGetLastError();
}

template <int CT>
static int qs_parent_launch(const float* img, const float* rho, int C,
                            long long H, long long W, QsTile t, float max_d2,
                            float* best_d2, int32_t* best_doff,
                            cudaStream_t stream) {
    const size_t smem = (size_t)(C + 1) * t.plane * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        qs_parent_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int tiles_x;
    const unsigned int blocks = qs_blocks(H, W, t.th, &tiles_x);
    qs_parent_kernel<CT><<<blocks, dim3(QS_TW, t.th), smem, stream>>>(
        img, rho, C, H, W, t, tiles_x, max_d2, best_d2, best_doff);
    return (int)cudaGetLastError();
}

// Launches the density scan on `stream` and returns cudaGetLastError().
// img: (C, H, W) float32, already scaled by the ratio; rho: (H, W) float32
// output; r: window radius; th: tile height (blockDim = (32, th)); inv2k2:
// 1 / (2 kernel_size^2) rounded to float32. Dynamic shared memory:
// C * (th + 2r) * (32 + 2r) * 4 bytes.
extern "C" int obia_qs_density(const void* img, int C, long long H,
                               long long W, int r, int th, float inv2k2,
                               void* rho, void* stream) {
    if (qs_bad(C, H, W, r, th)) return (int)cudaErrorInvalidValue;
    const QsTile t = qs_tile(r, th);
    const float* x = (const float*)img;
    float* out = (float*)rho;
    cudaStream_t s = (cudaStream_t)stream;
    switch (C > 8 ? 0 : C) {
        case 1: return qs_density_launch<1>(x, C, H, W, t, inv2k2, out, s);
        case 2: return qs_density_launch<2>(x, C, H, W, t, inv2k2, out, s);
        case 3: return qs_density_launch<3>(x, C, H, W, t, inv2k2, out, s);
        case 4: return qs_density_launch<4>(x, C, H, W, t, inv2k2, out, s);
        case 5: return qs_density_launch<5>(x, C, H, W, t, inv2k2, out, s);
        case 6: return qs_density_launch<6>(x, C, H, W, t, inv2k2, out, s);
        case 7: return qs_density_launch<7>(x, C, H, W, t, inv2k2, out, s);
        case 8: return qs_density_launch<8>(x, C, H, W, t, inv2k2, out, s);
        default: return qs_density_launch<0>(x, C, H, W, t, inv2k2, out, s);
    }
}

// Launches the parent scan on `stream` and returns cudaGetLastError().
// img: (C, H, W) float32 as for the density; rho: (H, W) float32 noised
// density; outputs best_d2 (H, W) float32 and best_doff (H, W) int32;
// max_d2: max_dist^2 rounded to float32. Dynamic shared memory:
// (C + 1) * (th + 2r) * (32 + 2r) * 4 bytes.
extern "C" int obia_qs_parent(const void* img, const void* rho, int C,
                              long long H, long long W, int r, int th,
                              float max_d2, void* best_d2, void* best_doff,
                              void* stream) {
    if (qs_bad(C, H, W, r, th)) return (int)cudaErrorInvalidValue;
    const QsTile t = qs_tile(r, th);
    const float* x = (const float*)img;
    const float* p = (const float*)rho;
    float* d = (float*)best_d2;
    int32_t* o = (int32_t*)best_doff;
    cudaStream_t s = (cudaStream_t)stream;
    switch (C > 8 ? 0 : C) {
        case 1: return qs_parent_launch<1>(x, p, C, H, W, t, max_d2, d, o, s);
        case 2: return qs_parent_launch<2>(x, p, C, H, W, t, max_d2, d, o, s);
        case 3: return qs_parent_launch<3>(x, p, C, H, W, t, max_d2, d, o, s);
        case 4: return qs_parent_launch<4>(x, p, C, H, W, t, max_d2, d, o, s);
        case 5: return qs_parent_launch<5>(x, p, C, H, W, t, max_d2, d, o, s);
        case 6: return qs_parent_launch<6>(x, p, C, H, W, t, max_d2, d, o, s);
        case 7: return qs_parent_launch<7>(x, p, C, H, W, t, max_d2, d, o, s);
        case 8: return qs_parent_launch<8>(x, p, C, H, W, t, max_d2, d, o, s);
        default: return qs_parent_launch<0>(x, p, C, H, W, t, max_d2, d, o, s);
    }
}
