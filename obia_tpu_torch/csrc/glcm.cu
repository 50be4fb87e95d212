// Per-object GLCM sums on Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel obia_tpu/ops/glcm_pallas.py::_kernel (launched by
// _glcm_jobs_call, core _accumulate_window). It computes the same thing: for
// every object k and every pixel-pair offset a, the ordered (centre,
// neighbour) grey-level pairs with both pixels in k, quantised in the kernel
// with the subtract-then-multiply form of obia_tpu/ops/glcm.scale_quantise, to
// per-(angle, object) sums. It does not carry the TPU design over: there is
// no one-hot matmul, no job table and no packed row/column field.
//
// Grid: one block per (object k, angle a). The block walks k's bounding box
// (from the _bbox_minmax pass) and counts canonical unordered level pairs
// (min(q1,q2), max(q1,q2)) into a shared-memory table of L(L+1)/2 counters,
// plus a histogram of |q1 - q2|. The epilogue turns both into exact sums:
//   n, sum d^2, sum |d|            from the |d| histogram (integers),
//   sum 1/(1+d^2)                  from the |d| histogram, in double, d = 0..L-1,
//   sum(i+j), sum(i^2+j^2), sum ij per-thread int64 sums, block-reduced,
//   sum (C + C^T)^2 = 4 sum D^2 + 2 sum U^2 over the diagonal (D) and
//                     off-diagonal (U) canonical bins, int64.
// Every integer sum is exact and the result does not depend on the order in
// which threads run, so it is the same from run to run.
//
// What bounds it on Hopper: the 32,896-counter table (L = 256) is 131,584
// bytes of shared memory, so one block fits on an SM, and every block zeroes
// and scans the whole table whatever the size of its object. Shared-memory
// atomics on that table and the |d| histogram carry the pixel work. Making it
// fast (several objects per block, a table sized to the object's level range)
// is later work.
//
// glcm_hist_kernel replaces obia_tpu/ops/glcm_pallas.py::_hist_kernel
// (launched by _glcm_hist_call): for the few objects that span a shard seam,
// the full directed co-occurrence table, which the sharded GLCM sums over the
// shards before it squares it. On the TPU a segment's jobs accumulate the
// (256, A*256) table in VMEM and the last job DMAs it to the segment's slot.
// Here one block per (slot, angle) walks the slot's box of centre pixels and
// adds one per pair with atomicAdd to a zeroed (M, L, A*L) int32 table in
// global memory: a 256 x 256 int32 table is 256 KB, more than the 227 KB a
// block can use, so shared memory cannot hold it. The output starts at zero,
// so no slot holds undefined bytes. What bounds it: global atomics, one per
// pair, spread over a 256 KB slab per block; at a few hundred seam spanners
// of a 4096^2 scene the pairs number a few million per band.
#include <cuda_runtime.h>
#include <stdint.h>

#define GLCM_THREADS 512
#define GLCM_MAX_ANGLES 8

struct GlcmOffsets {
    int dr[GLCM_MAX_ANGLES];
    int dc[GLCM_MAX_ANGLES];
};

// clip(floor((v - mn) * inv), 0, L - 1): the _rn intrinsics keep nvcc from
// contracting the subtract and multiply into an FMA, so the levels are
// bitwise those of the reference quantiser.
__device__ __forceinline__ int glcm_quantise(float v, float mn, float inv,
                                             int levels) {
    float f = floorf(__fmul_rn(__fsub_rn(v, mn), inv));
    f = fminf(fmaxf(f, 0.0f), (float)(levels - 1));
    return (int)f;
}

__device__ __forceinline__ long long warp_sum(long long v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(GLCM_THREADS)
glcm_sums_kernel(const int32_t* __restrict__ labels,
                 const float* __restrict__ band, long long H, long long W,
                 long long pix_stride, const int32_t* __restrict__ bbox,
                 const float* __restrict__ mn_k,
                 const float* __restrict__ inv_k, long long K, int levels,
                 GlcmOffsets offs, long long* __restrict__ isums,
                 double* __restrict__ hsum) {
    extern __shared__ unsigned int smem[];
    __shared__ long long red[4][GLCM_THREADS / 32];
    const int L = levels;
    const int n_bins = L * (L + 1) / 2;
    unsigned int* table = smem;
    unsigned int* dhist = smem + n_bins;

    const long long k = blockIdx.x;
    const int a = blockIdx.y;
    long long* out = isums + ((long long)a * K + k) * 7;
    const int r0 = bbox[4 * k], r1 = bbox[4 * k + 1];
    const int c0 = bbox[4 * k + 2], c1 = bbox[4 * k + 3];
    if (r0 > r1 || c0 > c1) {  // empty object: no pairs
        if (threadIdx.x < 7) out[threadIdx.x] = 0;
        if (threadIdx.x == 0) hsum[(long long)a * K + k] = 0.0;
        return;
    }
    for (int i = threadIdx.x; i < n_bins + L; i += GLCM_THREADS) smem[i] = 0u;
    __syncthreads();

    const int dr = offs.dr[a], dc = offs.dc[a];
    const float mn = mn_k[k], inv = inv_k[k];
    const int32_t lab = (int32_t)k;
    const long long nc = (long long)(c1 - c0 + 1);
    const long long npx = (long long)(r1 - r0 + 1) * nc;
    long long s_sum = 0, s_sq = 0, s_prod = 0;
    for (long long t = threadIdx.x; t < npx; t += GLCM_THREADS) {
        const long long r = r0 + t / nc, c = c0 + t % nc;
        const long long rn = r + dr, cn = c + dc;
        if (rn < 0 || rn >= H || cn < 0 || cn >= W) continue;
        const long long p = r * W + c, pn = rn * W + cn;
        if (labels[p] != lab || labels[pn] != lab) continue;
        const int q1 = glcm_quantise(band[p * pix_stride], mn, inv, L);
        const int q2 = glcm_quantise(band[pn * pix_stride], mn, inv, L);
        const int lo = min(q1, q2), hi = max(q1, q2);
        atomicAdd(&table[lo * L - lo * (lo - 1) / 2 + (hi - lo)], 1u);
        atomicAdd(&dhist[hi - lo], 1u);
        s_sum += q1 + q2;
        s_sq += q1 * q1 + q2 * q2;
        s_prod += q1 * q2;
    }
    __syncthreads();

    // sum over canonical bins of count^2, and again over the diagonal bins
    // (the first bin of each row lo): sum (C + C^T)^2 = 2 all + 2 diag
    long long sq = 0;
    for (int i = threadIdx.x; i < n_bins; i += GLCM_THREADS) {
        const long long c = table[i];
        sq += c * c;
    }
    for (int lo = threadIdx.x; lo < L; lo += GLCM_THREADS) {
        const long long c = table[lo * L - lo * (lo - 1) / 2];
        sq += c * c;
    }

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    s_sum = warp_sum(s_sum);
    s_sq = warp_sum(s_sq);
    s_prod = warp_sum(s_prod);
    sq = warp_sum(sq);
    if (lane == 0) {
        red[0][warp] = s_sum;
        red[1][warp] = s_sq;
        red[2][warp] = s_prod;
        red[3][warp] = sq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long tot[4] = {0, 0, 0, 0};
        for (int w = 0; w < GLCM_THREADS / 32; ++w)
            for (int j = 0; j < 4; ++j) tot[j] += red[j][w];
        long long n = 0, d1 = 0, d2 = 0;
        double h = 0.0;
        for (int d = 0; d < L; ++d) {
            const long long c = dhist[d];
            n += c;
            d1 += c * d;
            d2 += c * (long long)d * d;
            h += (double)c / (1.0 + (double)d * (double)d);
        }
        out[0] = n;
        out[1] = d2;
        out[2] = d1;
        out[3] = tot[0];
        out[4] = tot[1];
        out[5] = tot[2];
        out[6] = 2 * tot[3];
        hsum[(long long)a * K + k] = h;
    }
}

// Launches glcm_sums_kernel on `stream` and returns cudaGetLastError().
// labels: (H, W) int32; band: the first value of one band in an image whose
// pixels are pix_stride floats apart; bbox: (K, 4) int32 [rmin, rmax, cmin,
// cmax], rmin > rmax for an empty object; mn, inv: (K,) float32; offsets:
// HOST array of 2 * n_angles ints (dr, dc per angle). Outputs: isums
// (n_angles, K, 7) int64 [n, sum d^2, sum |d|, sum(i+j), sum(i^2+j^2),
// sum ij, sum (C+C^T)^2] and hsum (n_angles, K) double [sum 1/(1+d^2)].
extern "C" int obia_glcm_sums(const void* labels, const void* band,
                              long long H, long long W, long long pix_stride,
                              const void* bbox, const void* mn,
                              const void* inv, long long K, int levels,
                              const int* offsets, int n_angles, void* isums,
                              void* hsum, void* stream) {
    if (n_angles < 1 || n_angles > GLCM_MAX_ANGLES || levels < 1 ||
        levels > 256 || K < 1)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets offs;
    for (int a = 0; a < GLCM_MAX_ANGLES; ++a) {
        offs.dr[a] = a < n_angles ? offsets[2 * a] : 0;
        offs.dc[a] = a < n_angles ? offsets[2 * a + 1] : 0;
    }
    const size_t smem =
        (size_t)(levels * (levels + 1) / 2 + levels) * sizeof(unsigned int);
    cudaError_t err = cudaFuncSetAttribute(
        glcm_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned int)K, (unsigned int)n_angles);
    glcm_sums_kernel<<<grid, GLCM_THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)labels, (const float*)band, H, W, pix_stride,
        (const int32_t*)bbox, (const float*)mn, (const float*)inv, K, levels,
        offs, (long long*)isums, (double*)hsum);
    return (int)cudaGetLastError();
}

#define HIST_THREADS 256

__global__ void __launch_bounds__(HIST_THREADS)
glcm_hist_kernel(const int32_t* __restrict__ labels,
                 const float* __restrict__ band, long long H, long long W,
                 long long pix_stride, const int32_t* __restrict__ objs,
                 const int32_t* __restrict__ bbox,
                 const float* __restrict__ mn_k,
                 const float* __restrict__ inv_k, long long n_objects,
                 int levels, GlcmOffsets offs, int n_angles,
                 int* __restrict__ out) {
    const long long m = blockIdx.x;
    const int a = blockIdx.y;
    // the box, clipped to the raster so no centre read leaves it
    const int r0 = max(bbox[4 * m], 0);
    const int r1 = min(bbox[4 * m + 1], (int)H - 1);
    const int c0 = max(bbox[4 * m + 2], 0);
    const int c1 = min(bbox[4 * m + 3], (int)W - 1);
    const int32_t lab = objs[m];
    // no centre pixel on this block, or no such object
    if (r0 > r1 || c0 > c1 || lab < 0 || lab >= n_objects) return;
    const int L = levels;
    const long long row = (long long)n_angles * L;
    int* slab = out + m * L * row + (long long)a * L;  // [q1 * row + q2]
    const int dr = offs.dr[a], dc = offs.dc[a];
    const float mn = mn_k[lab], inv = inv_k[lab];
    const long long nc = (long long)(c1 - c0 + 1);
    const long long npx = (long long)(r1 - r0 + 1) * nc;
    for (long long t = threadIdx.x; t < npx; t += HIST_THREADS) {
        const long long r = r0 + t / nc, c = c0 + t % nc;
        const long long rn = r + dr, cn = c + dc;
        if (rn < 0 || rn >= H || cn < 0 || cn >= W) continue;
        const long long p = r * W + c, pn = rn * W + cn;
        if (labels[p] != lab || labels[pn] != lab) continue;
        const int q1 = glcm_quantise(band[p * pix_stride], mn, inv, L);
        const int q2 = glcm_quantise(band[pn * pix_stride], mn, inv, L);
        atomicAdd(&slab[(long long)q1 * row + q2], 1);
    }
}

// Launches glcm_hist_kernel on `stream` and returns cudaGetLastError().
// labels, band, pix_stride, mn, inv (n_objects,), levels, offsets: as
// obia_glcm_sums. objs: (M,) int32 object ids; bbox: (M, 4) int32 boxes of
// the centre pixels to visit per slot. out: (M, levels, n_angles * levels)
// int32, zeroed by the caller; entry [m, i, a * levels + j] counts the pairs
// at offset a of object objs[m] with centre level i and neighbour level j;
// a slot whose id is outside 0..n_objects-1 stays zero.
extern "C" int obia_glcm_hist(const void* labels, const void* band,
                              long long H, long long W, long long pix_stride,
                              const void* objs, const void* bbox,
                              const void* mn, const void* inv, long long M,
                              long long n_objects, int levels,
                              const int* offsets, int n_angles, void* out,
                              void* stream) {
    if (n_angles < 1 || n_angles > GLCM_MAX_ANGLES || levels < 1 ||
        levels > 256 || M < 1 || n_objects < 1)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets offs;
    for (int a = 0; a < GLCM_MAX_ANGLES; ++a) {
        offs.dr[a] = a < n_angles ? offsets[2 * a] : 0;
        offs.dc[a] = a < n_angles ? offsets[2 * a + 1] : 0;
    }
    dim3 grid((unsigned int)M, (unsigned int)n_angles);
    glcm_hist_kernel<<<grid, HIST_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)labels, (const float*)band, H, W, pix_stride,
        (const int32_t*)objs, (const int32_t*)bbox, (const float*)mn,
        (const float*)inv, n_objects, levels, offs, n_angles, (int*)out);
    return (int)cudaGetLastError();
}
