// Per-object GLCM sums on Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel obia_tpu/ops/glcm_pallas.py::_kernel (launched by
// _glcm_jobs_call, core _accumulate_window). It computes the same thing: for
// every object k and every pixel-pair offset a, the ordered (centre,
// neighbour) grey-level pairs with the centre in k's box and both pixels in
// k, quantised with the subtract-then-multiply form of
// obia_tpu/ops/glcm.scale_quantise, to per-(angle, object) sums:
//   n, sum d^2, sum |d|, sum(i+j), sum(i^2+j^2), sum ij   (int64, exact)
//   sum (C + C^T)^2 = 2 sum_keys c^2 + 2 sum_diag c^2     (int64, exact)
//   sum 1/(1+d^2)                                          (double)
// over the canonical keys (min(i,j), max(i,j)) and their counts c. It does
// not carry the TPU design over: no one-hot matmul, no job table.
//
// One call is three launches on one stream, with no host sync:
//   1. glcm_pack_kernel: every pixel once, (label << 8) | level under its
//      own object's quantiser (-1 outside every object), so no pixel is
//      read from the interleaved image or quantised twice.
//   2. glcm_small_kernel: a warp per object over all angles. An object whose
//      box (clipped to the raster) holds at most GLCM_SMALL_CAP pixels is
//      summed here: the lanes walk the box, compact the pair keys into the
//      warp's shared buffer, and count sum_keys c^2 as sum over pairs of the
//      number of equal keys (O(P^2 / 32) compares for P <= GLCM_SMALL_CAP). An
//      empty box writes zeros; a larger box appends its id to a list.
//   3. glcm_large_kernel: persistent blocks of 1024 threads, one per SM,
//      take (listed object, angle) items from a counter. Each zeroes a
//      shared table of the L(L+1)/2 canonical counters and walks the box
//      (rows over warps, columns over lanes); every pair adds one to its
//      key with an atomic that returns the old count c, so 2c + 1 summed
//      over the pairs is sum_keys c^2 without scanning the table. Its grid
//      (SMs x resident blocks) is asked of the runtime once per device and
//      level count, not on every call.
// The object's size class is decided on the device from its box. Integer
// sums are exact; the double sum 1/(1+d^2) adds per-thread partials in a
// fixed order, so every output is the same from run to run whichever block
// takes an item.
//
// What bounds it: the pack pass reads the labels and the 32-byte sectors
// that hold the band of the interleaved image (a 4096^2 x 8 scene: 67 MB +
// 537 MB) and writes 67 MB; the pair walk reads the packed raster again,
// mostly from L2. The large kernel's 131,584-byte table (L = 256) allows
// one block per SM, and its shared atomics carry the pair work.
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

#include <atomic>

#define GLCM_MAX_ANGLES 8
#define GLCM_PACK_THREADS 256
#define GLCM_SMALL_CAP 256      // most pixels in a box of the small class
                                // (SMALL_MAX_PX in ops/glcm_kernel.py)
#define GLCM_SMALL_WARPS 8      // objects per block of the small kernel
#define GLCM_LARGE_THREADS 1024

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// The sums of one (object, angle), as each thread accumulates them.
struct PairSums {
    long long n, d2, d1, s, sq, p, c2, c2d;  // c2: sum_keys c^2; c2d: diagonal
    double h;

    __device__ __forceinline__ void add(int q1, int q2, const double* wtab) {
        const int d = abs(q1 - q2);
        n += 1;
        d2 += d * d;
        d1 += d;
        s += q1 + q2;
        sq += q1 * q1 + q2 * q2;
        p += q1 * q2;
        h += wtab[d];
    }

    __device__ __forceinline__ void warp_reduce() {
        n = warp_sum(n);
        d2 = warp_sum(d2);
        d1 = warp_sum(d1);
        s = warp_sum(s);
        sq = warp_sum(sq);
        p = warp_sum(p);
        c2 = warp_sum(c2);
        c2d = warp_sum(c2d);
        h = warp_sum(h);
    }

    __device__ __forceinline__ void store(long long* out, double* hout) const {
        out[0] = n;
        out[1] = d2;
        out[2] = d1;
        out[3] = s;
        out[4] = sq;
        out[5] = p;
        out[6] = 2 * (c2 + c2d);
        *hout = h;
    }
};

// 1/(1+d^2) for d = 0..levels-1, rounded as the twin's float64 division.
__device__ __forceinline__ void fill_wtab(double* wtab, int levels) {
    for (int d = threadIdx.x; d < levels; d += blockDim.x)
        wtab[d] = 1.0 / (1.0 + (double)d * (double)d);
}

// k's box clipped to the raster; false when nothing is left.
__device__ __forceinline__ bool clipped_box(const int32_t* bbox, long long k,
                                            long long H, long long W, int& r0,
                                            int& r1, int& c0, int& c1) {
    r0 = max(bbox[4 * k], 0);
    r1 = (int)min((long long)bbox[4 * k + 1], H - 1);
    c0 = max(bbox[4 * k + 2], 0);
    c1 = (int)min((long long)bbox[4 * k + 3], W - 1);
    return r0 <= r1 && c0 <= c1;
}

__global__ void __launch_bounds__(GLCM_PACK_THREADS)
glcm_pack_kernel(const int32_t* __restrict__ labels,
                 const float* __restrict__ band, long long HW,
                 long long pix_stride, const float* __restrict__ mn_k,
                 const float* __restrict__ inv_k, long long K, int levels,
                 int32_t* __restrict__ packed, int* __restrict__ counters) {
    if (blockIdx.x == 0 && threadIdx.x < 2) counters[threadIdx.x] = 0;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         p < HW; p += step) {
        const int lab = labels[p];
        int v = -1;
        if (lab >= 0 && lab < K)
            v = (lab << 8) |
                glcm_quantise(band[p * pix_stride], mn_k[lab], inv_k[lab],
                              levels);
        packed[p] = v;
    }
}

__global__ void __launch_bounds__(GLCM_SMALL_WARPS * 32)
glcm_small_kernel(const int32_t* __restrict__ packed, long long H,
                  long long W, const int32_t* __restrict__ bbox, long long K,
                  int levels, GlcmOffsets offs, int n_angles,
                  long long* __restrict__ isums, double* __restrict__ hsum,
                  int* __restrict__ counters, int32_t* __restrict__ large_ids) {
    __shared__ int keys[GLCM_SMALL_WARPS][GLCM_SMALL_CAP];
    __shared__ double wtab[256];
    fill_wtab(wtab, levels);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long k = (long long)blockIdx.x * GLCM_SMALL_WARPS + warp;
    if (k >= K) return;
    int r0, r1, c0, c1;
    int npx = 0, bw = 1;
    if (clipped_box(bbox, k, H, W, r0, r1, c0, c1)) {
        const long long area = (long long)(r1 - r0 + 1) * (c1 - c0 + 1);
        if (area > GLCM_SMALL_CAP) {  // the large kernel sums it
            if (lane == 0) large_ids[atomicAdd(&counters[0], 1)] = (int32_t)k;
            return;
        }
        npx = (int)area;
        bw = c1 - c0 + 1;
    }
    int* buf = keys[warp];
    const int32_t lab = (int32_t)k;
    const unsigned below = (1u << lane) - 1u;
    for (int a = 0; a < n_angles; ++a) {
        const int dr = offs.dr[a], dc = offs.dc[a];
        PairSums acc = {0, 0, 0, 0, 0, 0, 0, 0, 0.0};
        int n_keys = 0;
        for (int t0 = 0; t0 < npx; t0 += 32) {
            const int t = t0 + lane;
            bool ok = false;
            int key = 0;
            if (t < npx) {
                const int r = r0 + t / bw, c = c0 + t % bw;
                const int rn = r + dr, cn = c + dc;
                const int v = packed[(long long)r * W + c];
                const int w = (rn >= 0 && rn < H && cn >= 0 && cn < W)
                                  ? packed[(long long)rn * W + cn]
                                  : -1;
                if ((v >> 8) == lab && (w >> 8) == lab) {
                    const int q1 = v & 255, q2 = w & 255;
                    acc.add(q1, q2, wtab);
                    key = (min(q1, q2) << 8) | max(q1, q2);
                    ok = true;
                }
            }
            const unsigned m = __ballot_sync(0xffffffffu, ok);
            if (ok) buf[n_keys + __popc(m & below)] = key;
            n_keys += __popc(m);
        }
        __syncwarp();
        for (int i = lane; i < n_keys; i += 32) {
            const int ki = buf[i];
            int same = 0;
            for (int j = 0; j < n_keys; ++j) same += buf[j] == ki;
            acc.c2 += same;
            if ((ki >> 8) == (ki & 255)) acc.c2d += same;
        }
        __syncwarp();  // the next angle overwrites buf
        acc.warp_reduce();
        if (lane == 0)
            acc.store(isums + ((long long)a * K + k) * 7,
                      hsum + (long long)a * K + k);
    }
}

__global__ void __launch_bounds__(GLCM_LARGE_THREADS)
glcm_large_kernel(const int32_t* __restrict__ packed, long long H,
                  long long W, const int32_t* __restrict__ bbox, long long K,
                  int levels, GlcmOffsets offs, int n_angles,
                  long long* __restrict__ isums, double* __restrict__ hsum,
                  int* __restrict__ counters,
                  const int32_t* __restrict__ large_ids) {
    extern __shared__ unsigned int table[];  // L(L+1)/2 canonical counters
    __shared__ double wtab[256];
    __shared__ long long red[8][GLCM_LARGE_THREADS / 32];
    __shared__ double red_h[GLCM_LARGE_THREADS / 32];
    __shared__ int item_sh;
    const int L = levels;
    const int n_bins = L * (L + 1) / 2;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    fill_wtab(wtab, levels);
    const int n_items = counters[0] * n_angles;  // written by the small kernel
    for (;;) {
        __syncthreads();  // the last item's readers are done
        if (threadIdx.x == 0) item_sh = atomicAdd(&counters[1], 1);
        for (int i = threadIdx.x; i < n_bins; i += blockDim.x) table[i] = 0u;
        __syncthreads();
        const int item = item_sh;
        if (item >= n_items) break;
        const long long k = large_ids[item / n_angles];
        const int a = item % n_angles;
        int r0, r1, c0, c1;
        clipped_box(bbox, k, H, W, r0, r1, c0, c1);  // non-empty: listed
        const int dr = offs.dr[a], dc = offs.dc[a];
        const int32_t lab = (int32_t)k;
        PairSums acc = {0, 0, 0, 0, 0, 0, 0, 0, 0.0};
        for (int r = r0 + warp; r <= r1; r += n_warps) {
            const int rn = r + dr;
            if (rn < 0 || rn >= H) continue;
            const int32_t* row = packed + (long long)r * W;
            const int32_t* nrow = packed + (long long)rn * W;
            for (int c = c0 + lane; c <= c1; c += 32) {
                // both loads go out before either is tested: one latency
                const int cn = c + dc;
                const int v = row[c];
                const int w = (cn >= 0 && cn < W) ? nrow[cn] : -1;
                if ((v >> 8) != lab || (w >> 8) != lab) continue;
                const int q1 = v & 255, q2 = w & 255;
                const int lo = min(q1, q2), hi = max(q1, q2);
                const unsigned old = atomicAdd(
                    &table[lo * L - lo * (lo - 1) / 2 + (hi - lo)], 1u);
                const long long inc = 2LL * old + 1;
                acc.c2 += inc;
                if (lo == hi) acc.c2d += inc;
                acc.add(q1, q2, wtab);
            }
        }
        acc.warp_reduce();
        if (lane == 0) {
            red[0][warp] = acc.n;
            red[1][warp] = acc.d2;
            red[2][warp] = acc.d1;
            red[3][warp] = acc.s;
            red[4][warp] = acc.sq;
            red[5][warp] = acc.p;
            red[6][warp] = acc.c2;
            red[7][warp] = acc.c2d;
            red_h[warp] = acc.h;
        }
        __syncthreads();
        if (warp == 0) {
            const bool on = lane < n_warps;
            PairSums tot;
            tot.n = on ? red[0][lane] : 0;
            tot.d2 = on ? red[1][lane] : 0;
            tot.d1 = on ? red[2][lane] : 0;
            tot.s = on ? red[3][lane] : 0;
            tot.sq = on ? red[4][lane] : 0;
            tot.p = on ? red[5][lane] : 0;
            tot.c2 = on ? red[6][lane] : 0;
            tot.c2d = on ? red[7][lane] : 0;
            tot.h = on ? red_h[lane] : 0.0;
            tot.warp_reduce();
            if (lane == 0)
                tot.store(isums + ((long long)a * K + k) * 7,
                          hsum + (long long)a * K + k);
        }
    }
}

// Bytes of the large kernel's canonical table at `levels`.
static size_t large_smem(int levels) {
    return (size_t)(levels * (levels + 1) / 2) * sizeof(unsigned int);
}

#define GLCM_MAX_DEVICES 64

// The large kernel's grid on the current device: its SMs times the blocks
// of `levels`' table that fit on one. The runtime is asked once per (device,
// levels); the shared-memory limit is raised once per device to the table
// of 256 levels. Concurrent first calls ask twice and store the same value.
static cudaError_t large_grid(int levels, int* grid) {
    static std::atomic<int> cache[GLCM_MAX_DEVICES][257];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < GLCM_MAX_DEVICES) {
        *grid = cache[device][levels].load(std::memory_order_relaxed);
        if (*grid > 0) return cudaSuccess;
    }
    err = cudaFuncSetAttribute(glcm_large_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)large_smem(256));
    int n_sms = 0, per_sm = 0;
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, glcm_large_kernel, GLCM_LARGE_THREADS,
            large_smem(levels));
    if (err != cudaSuccess) return err;
    *grid = n_sms * (per_sm > 0 ? per_sm : 1);
    if (device < GLCM_MAX_DEVICES)
        cache[device][levels].store(*grid, std::memory_order_relaxed);
    return cudaSuccess;
}

// Launches the three sums kernels on `stream` and returns the first
// non-zero cudaGetLastError(). labels: (H, W) int32; band: the first value
// of one band in an image whose pixels are pix_stride floats apart; bbox:
// (K, 4) int32 [rmin, rmax, cmin, cmax], rmin > rmax for an empty object;
// mn, inv: (K,) float32; offsets: HOST array of 2 * n_angles ints (dr, dc
// per angle); scratch: H * W + K + 2 int32 of device memory.
// Outputs, every entry written: isums (n_angles, K, 7) int64 [n, sum d^2,
// sum |d|, sum(i+j), sum(i^2+j^2), sum ij, sum (C+C^T)^2] and hsum
// (n_angles, K) double [sum 1/(1+d^2)]. K must be below 2^23 (the packed
// label takes 23 bits).
extern "C" int obia_glcm_sums(const void* labels, const void* band,
                              long long H, long long W, long long pix_stride,
                              const void* bbox, const void* mn,
                              const void* inv, long long K, int levels,
                              const int* offsets, int n_angles,
                              void* scratch, void* isums, void* hsum,
                              void* stream) {
    if (n_angles < 1 || n_angles > GLCM_MAX_ANGLES || levels < 1 ||
        levels > 256 || K < 1 || K >= (1LL << 23) || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets offs;
    for (int a = 0; a < GLCM_MAX_ANGLES; ++a) {
        offs.dr[a] = a < n_angles ? offsets[2 * a] : 0;
        offs.dc[a] = a < n_angles ? offsets[2 * a + 1] : 0;
    }
    const long long HW = H * W;
    int32_t* packed = (int32_t*)scratch;
    int32_t* large_ids = packed + HW;
    int* counters = (int*)(large_ids + K);
    cudaStream_t s = (cudaStream_t)stream;

    long long pack_blocks = (HW + GLCM_PACK_THREADS - 1) / GLCM_PACK_THREADS;
    if (pack_blocks > (1LL << 16)) pack_blocks = 1LL << 16;  // grid-stride
    glcm_pack_kernel<<<(unsigned int)pack_blocks, GLCM_PACK_THREADS, 0, s>>>(
        (const int32_t*)labels, (const float*)band, HW, pix_stride,
        (const float*)mn, (const float*)inv, K, levels, packed, counters);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    glcm_small_kernel<<<(unsigned int)((K + GLCM_SMALL_WARPS - 1) /
                                       GLCM_SMALL_WARPS),
                        GLCM_SMALL_WARPS * 32, 0, s>>>(
        packed, H, W, (const int32_t*)bbox, K, levels, offs,
        n_angles, (long long*)isums, (double*)hsum, counters, large_ids);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    int grid = 0;
    err = large_grid(levels, &grid);
    if (err != cudaSuccess) return (int)err;
    glcm_large_kernel<<<(unsigned int)grid, GLCM_LARGE_THREADS,
                        large_smem(levels), s>>>(
        packed, H, W, (const int32_t*)bbox, K, levels, offs, n_angles,
        (long long*)isums, (double*)hsum, counters, large_ids);
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
