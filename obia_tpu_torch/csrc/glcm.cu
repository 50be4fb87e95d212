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
// glcm_spanner_hist_kernel replaces obia_tpu/ops/glcm_pallas.py::_hist_kernel
// (launched by _glcm_hist_call) and the psum and square that
// obia_tpu/parallel/glcm_sharded.py runs after it. An object that spans a
// shard seam needs its directed co-occurrence table summed over the shards,
// and the exact sum (C + C^T)^2 of that sum, which is not a sum of per-shard
// values. On the TPU each shard accumulates a (256, A*256) table a spanner in
// VMEM, and XLA sums the tables over the mesh and squares them. Here every
// shard lies on the one card, so one launch a band does all of it.
// Persistent thread-block clusters, as many as fit the card at once, take
// the (spanner, angle) items in a fixed order. For each, the cluster walks
// the spanner's pieces on every shard (a CSR list: the shard and the box of
// centre pixels, in that shard's halo coordinates) and counts the pairs into
// a table in shared memory. A table that fits SPAN_TABLE_BYTES (L <= 155)
// takes a cluster of one 512-thread block, two an SM, so one block's walk
// hides the other's barriers. At L = 256 the table is 256 KB, more than the
// 227 KB a block may use, so a cluster of two 1024-thread blocks splits it
// by centre level: block r holds rows [r * rows, r * rows + rows). Each
// block walks the boxes whole and counts only the pairs whose centre level
// is one of its rows, so every atomic lands in its own shared memory (an
// atomic through distributed shared memory costs more than the second read
// of a pixel, which the other block has brought into L2). Each thread loads
// four pixels' labels and values, held in registers, before it tests any,
// so the walk waits one memory latency per four pixels.
// A spanner's few thousand pairs at an angle touch a few thousand of the
// table's L^2 cells, so the atomic that turns a cell nonzero also lists it
// (up to SPAN_CELLS a block). After a cluster barrier each block sums in
// int64 (C_ij + C_ji)^2 = 2 C_ij^2 + 2 C_ij C_ji over its listed cells,
// reading C_ji from the block that owns row j, and zeroes those cells for
// the next item: the table is cleared once a launch, not once an item. Two
// cluster barriers an item suffice, as no block writes another's memory
// but block 0's parts.
// Where a list overflowed, or the caller asks for the tables (shards on
// several devices, whose tables are summed afterwards), the blocks scan
// their rows whole instead, storing every entry (coalesced; the output
// needs no memset), the products between two blocks' rows split between
// the two, each reading the other's rows whole (a column read across the
// cluster would cost a transfer an entry). Rows lie L | 1 words apart
// (odd), so column reads of C^T fall on distinct banks. The blocks' parts
// meet in block 0, which writes the total. Integer sums and a fixed item
// order make every output the same from run to run.
// What bounds it: the walk's latency, a spanner's boxes read once for each
// angle (8 bytes a pixel, mostly from L2), and two cluster barriers an
// item.
#include <cooperative_groups.h>
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

#define SPAN_THREADS 1024      // threads of a block of a two-block cluster
#define SPAN_TABLE_BYTES 96256  // the largest table one block holds: two
                                // 512-thread blocks, with their cell lists,
                                // fit an SM
#define SPAN_CELLS 4096         // nonzero cells a block lists
#define SPAN_SMEM_BYTES ((128 * 257 + SPAN_CELLS) * 4)  // half of L = 256

namespace cg = cooperative_groups;

// One pixel of a spanner's walk: its label and value and its neighbour's.
struct SpanPix {
    int l, ln;
    float v, vn;
};

// Loads pixel t of a box of npx centre pixels nc wide from (r0, c0). The
// loads do not wait on a test: a pixel past the box, or whose neighbour
// lies off the block, reads pixel 0 and takes label -1, so the walk holds
// its pixels in registers and starts all their loads before any compare.
__device__ __forceinline__ SpanPix span_load(
    const int32_t* __restrict__ lab, const float* __restrict__ img, int C,
    int H, int W, int t, int npx, int nc, int r0, int c0, int dr, int dc) {
    const int r = r0 + t / nc, c = c0 + t % nc;
    const int rn = r + dr, cn = c + dc;
    const bool ok = t < npx && rn >= 0 && rn < H && cn >= 0 && cn < W;
    const long long pix = ok ? (long long)r * W + c : 0;
    const long long pn = ok ? (long long)rn * W + cn : 0;
    const int l = lab[pix], ln = lab[pn];
    SpanPix p;
    p.l = ok ? l : -1;
    p.ln = ok ? ln : -1;
    p.v = img[pix * C];
    p.vn = img[pn * C];
    return p;
}

// Adds the pair of p to this block's table if both its pixels are object
// k's and its centre level is one of the block's rows [row0, row0 + rows).
// The atomic that turns a cell nonzero lists it in cells, and n counts the
// cells that turned nonzero (it may pass SPAN_CELLS).
__device__ __forceinline__ void span_count(const SpanPix& p, int k, float mn,
                                           float inv, int L, int row0,
                                           int rows, int Lp, int* table,
                                           int* cells, int* n) {
    if (p.l != k || p.ln != k) return;
    const int il = glcm_quantise(p.v, mn, inv, L) - row0;
    if (il < 0 || il >= rows) return;
    const int cell = il * Lp + glcm_quantise(p.vn, mn, inv, L);
    if (atomicAdd(table + cell, 1) == 0) {
        const int i = atomicAdd(n, 1);
        if (i < SPAN_CELLS) cells[i] = cell;
    }
}

__global__ void __launch_bounds__(SPAN_THREADS, 1)
glcm_spanner_hist_kernel(const long long* __restrict__ lab_base,
                         const long long* __restrict__ img_base, int n_shards,
                         int H, int W, int C, int band,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ piece_ptr,
                         const int32_t* __restrict__ pieces,
                         const float* __restrict__ mn_k,
                         const float* __restrict__ inv_k, long long K,
                         int levels, int rows, GlcmOffsets offs, long long M,
                         int A, int* __restrict__ tables,
                         long long* __restrict__ sumsq) {
    extern __shared__ int span_smem[];
    __shared__ int span_n;
    __shared__ long long red[SPAN_THREADS / 32];
    __shared__ long long part[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int ncta = (int)cluster.dim_blocks().x;  // 1 or 2
    const int L = levels, Lp = levels | 1;
    const int row0 = rank * rows;
    const int nrows = min(rows, L - row0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    int* const table = span_smem;  // this block's rows
    int* const cells = span_smem + rows * Lp;
    for (int i = threadIdx.x; i < rows * Lp; i += blockDim.x) table[i] = 0;
    if (threadIdx.x == 0) span_n = 0;
    cluster.sync();  // every block's rows are zero before a pair lands

    // a persistent cluster takes the (spanner, angle) items cid, cid + G,
    // ...: the same items whatever the timing, and integer sums, so every
    // output is the same from run to run
    const long long n_items = M * A;
    const int G = gridDim.x / ncta;
    // the item's spanner id and piece range, loaded an item ahead so the
    // walk does not wait for them
    long long item = blockIdx.x / ncta;
    int32_t k_next = 0, p_next = 0, end_next = 0;
    if (item < n_items) {
        k_next = ids[item / A];
        p_next = piece_ptr[item / A];
        end_next = piece_ptr[item / A + 1];
    }
    for (; item < n_items; item += G) {
        const long long m = item / A;
        const int a = (int)(item % A);
        const int32_t k = k_next;
        const int p_begin = p_next, p_end = end_next;
        if (item + G < n_items) {
            const long long m2 = (item + G) / A;
            k_next = ids[m2];
            p_next = piece_ptr[m2];
            end_next = piece_ptr[m2 + 1];
        }
        if (k >= 0 && k < K) {
            const float mn = mn_k[k], inv = inv_k[k];
            // offs indexed by constants only: a parameter read at a run-time
            // index is copied to the stack first
            int dr = 0, dc = 0;
#pragma unroll
            for (int i = 0; i < GLCM_MAX_ANGLES; ++i) {
                dr = i == a ? offs.dr[i] : dr;
                dc = i == a ? offs.dc[i] : dc;
            }
            for (int p = p_begin; p < p_end; ++p) {
                const int32_t* pc = pieces + 5LL * p;
                const int s = pc[0];
                // the box, clipped to the block so no centre read leaves it
                const int r0 = max(pc[1], 0), r1 = min(pc[2], H - 1);
                const int c0 = max(pc[3], 0), c1 = min(pc[4], W - 1);
                if (s < 0 || s >= n_shards || r0 > r1 || c0 > c1) continue;
                const int32_t* lab = (const int32_t*)lab_base[s];
                const float* img = (const float*)img_base[s] + band;
                const int nc = c1 - c0 + 1;
                const int npx = (r1 - r0 + 1) * nc;
                // the whole box, in every block; four pixels a thread, every
                // load out before a compare
                const int step = blockDim.x;
                for (int t = threadIdx.x; t < npx; t += 4 * step) {
                    const SpanPix p0 = span_load(lab, img, C, H, W, t, npx,
                                                 nc, r0, c0, dr, dc);
                    const SpanPix p1 = span_load(lab, img, C, H, W, t + step,
                                                 npx, nc, r0, c0, dr, dc);
                    const SpanPix p2 = span_load(lab, img, C, H, W,
                                                 t + 2 * step, npx, nc, r0,
                                                 c0, dr, dc);
                    const SpanPix p3 = span_load(lab, img, C, H, W,
                                                 t + 3 * step, npx, nc, r0,
                                                 c0, dr, dc);
                    span_count(p0, k, mn, inv, L, row0, nrows, Lp, table,
                               cells, &span_n);
                    span_count(p1, k, mn, inv, L, row0, nrows, Lp, table,
                               cells, &span_n);
                    span_count(p2, k, mn, inv, L, row0, nrows, Lp, table,
                               cells, &span_n);
                    span_count(p3, k, mn, inv, L, row0, nrows, Lp, table,
                               cells, &span_n);
                }
            }
        }
        cluster.sync();  // every pair is counted

        // sum (C_ij + C_ji)^2 = 2 sum C_ij^2 + 2 sum C_ij C_ji. When every
        // block listed all its nonzero cells and no table is asked for, each
        // block sums its listed cells, reading C_ji from whichever block owns
        // row j. Otherwise each block scans its rows whole (and stores them):
        // the squares and the products within its rows as it goes; the
        // products between two blocks' rows (twice the sum over i in the
        // lower block, j in the higher) split between the two by j, each
        // reading rows of the other whole (coalesced) and the matching
        // column of its own (odd row pitch: no bank conflict).
        const int n_own = span_n;
        bool whole = tables != nullptr;
        for (int b = 0; b < ncta; ++b)
            whole = whole || *cluster.map_shared_rank(&span_n, b) > SPAN_CELLS;
        long long acc = 0;
        if (!whole) {
            for (int e = threadIdx.x; e < n_own; e += blockDim.x) {
                const int cell = cells[e];
                const int il = cell / Lp, j = cell - il * Lp;
                const int ow = j / rows;  // the block that owns row j
                const int at = (j - ow * rows) * Lp + row0 + il;
                const int cji = ow == rank
                                    ? table[at]
                                    : cluster.map_shared_rank(table, ow)[at];
                const long long cij = table[cell];
                acc += cij * cij + cij * cji;
            }
            acc *= 2;
        } else {
            for (int il = warp; il < nrows; il += n_warps) {
                const int i = row0 + il;
                const int* row = table + il * Lp;
                int* out = tables == nullptr
                               ? nullptr
                               : tables + ((m * L + i) * A + a) * (long long)L;
                long long sq = 0, tr = 0;
                for (int j = lane; j < L; j += 32) {
                    const int cij = row[j];
                    if (out != nullptr) out[j] = cij;
                    sq += (long long)cij * cij;
                    const int jl = j - row0;
                    if (jl >= 0 && jl < nrows)
                        tr += (long long)cij * table[jl * Lp + i];
                }
                acc += 2 * sq + 2 * tr;
            }
            long long x = 0;
            for (int b = 0; b < ncta; ++b) {
                if (b == rank) continue;
                const int* other = cluster.map_shared_rank(table, b);
                const int b0 = b * rows;                  // its first row
                const int nb = max(min(rows, L - b0), 0);  // and its count
                if (rank < b) {
                    // rows j = b0 + jl, jl < nb / 2, of the higher block b
                    for (int jl = warp; jl < nb / 2; jl += n_warps) {
                        const int* orow = other + jl * Lp;
#pragma unroll 4
                        for (int il = lane; il < nrows; il += 32)
                            x += (long long)orow[row0 + il] *
                                 table[il * Lp + b0 + jl];
                    }
                } else {
                    // this block's rows jl >= nrows / 2 against the lower b
                    for (int il = warp; il < nb; il += n_warps) {
                        const int* orow = other + il * Lp;  // row b0 + il
#pragma unroll 2
                        for (int jl = nrows / 2 + lane; jl < nrows; jl += 32)
                            x += (long long)orow[row0 + jl] *
                                 table[jl * Lp + b0 + il];
                    }
                }
            }
            acc += 4 * x;
        }
        acc = warp_sum(acc);
        if (lane == 0) red[warp] = acc;
        __syncthreads();
        if (warp == 0) {
            long long v = lane < n_warps ? red[lane] : 0;
            v = warp_sum(v);
            if (lane == 0) cluster.map_shared_rank(&part[0], 0)[rank] = v;
        }
        // every block's part is in, and no block reads another's rows or
        // count again for this item
        cluster.sync();
        if (rank == 0 && threadIdx.x == 0) {
            long long total = 0;
            for (int b = 0; b < ncta; ++b) total += part[b];
            sumsq[(long long)a * M + m] = total;
        }
        // zero what this item counted, for the next
        if (whole) {
            for (int i = threadIdx.x; i < rows * Lp; i += blockDim.x)
                table[i] = 0;
        } else {
            for (int e = threadIdx.x; e < n_own; e += blockDim.x)
                table[cells[e]] = 0;
        }
        if (threadIdx.x == 0) span_n = 0;
        // this block's table is zero before its next pairs; a block's
        // atomics stay in its own table, and the other block reads this
        // one's rows and count again only after the next item's first
        // cluster barrier
        __syncthreads();
    }
}

// The kernel's grid on the current device: the clusters of `levels`' table
// that can run at once, each launched as ncta blocks. The runtime is asked
// once per (device, levels); the shared-memory limit is raised once per
// device. Concurrent first calls ask twice and store the same value.
static cudaError_t spanner_grid(int levels, int ncta, int threads,
                                size_t smem, int* clusters) {
    static std::atomic<int> cache[GLCM_MAX_DEVICES][257];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < GLCM_MAX_DEVICES) {
        *clusters = cache[device][levels].load(std::memory_order_relaxed);
        if (*clusters > 0) return cudaSuccess;
    }
    err = cudaFuncSetAttribute(glcm_spanner_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SPAN_SMEM_BYTES);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            glcm_spanner_hist_kernel,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)ncta, 1, 1);
    cfg.blockDim = dim3((unsigned int)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, glcm_spanner_hist_kernel, &cfg);
    if (err != cudaSuccess) return err;
    *clusters = n > 0 ? n : 1;
    if (device < GLCM_MAX_DEVICES)
        cache[device][levels].store(*clusters, std::memory_order_relaxed);
    return cudaSuccess;
}

// Launches glcm_spanner_hist_kernel on `stream` and returns the launch's
// error or cudaGetLastError(). lab_base, img_base: DEVICE arrays of
// n_shards addresses of the shards' (H, W) int32 label blocks and (H, W, C)
// float32 image blocks, all of one shape; band selects the channel. ids:
// (M,) int32 object ids of the spanners; piece_ptr: (M + 1,) int32 offsets
// into pieces: (P, 5) int32 [shard, rmin, rmax, cmin, cmax], the boxes of
// centre pixels to visit, at most one a (spanner, shard). mn, inv: (K,)
// float32; offsets: HOST array of 2 * n_angles ints. Outputs, every entry
// written: sumsq (n_angles, M) int64, sum (C + C^T)^2 of each spanner's
// table at each offset; and, unless tables is null, tables (M, levels,
// n_angles * levels) int32, entry [m, i, a * levels + j] the pairs at offset
// a of object ids[m] over all its pieces with centre level i and neighbour
// level j. An id outside 0..K-1 leaves its table and its sum at zero.
extern "C" int obia_glcm_spanner_hist(
    const void* lab_base, const void* img_base, int n_shards, long long H,
    long long W, long long C, int band, const void* ids,
    const void* piece_ptr, const void* pieces, long long M, const void* mn,
    const void* inv, long long K, int levels, const int* offsets,
    int n_angles, void* tables, void* sumsq, void* stream) {
    if (n_angles < 1 || n_angles > GLCM_MAX_ANGLES || levels < 1 ||
        levels > 256 || M < 1 || M > (1LL << 30) || K < 1 || n_shards < 1 ||
        H < 1 || W < 1 || H * W >= (1LL << 31) || C < 1 || band < 0 ||
        band >= C)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets offs;
    for (int a = 0; a < GLCM_MAX_ANGLES; ++a) {
        offs.dr[a] = a < n_angles ? offsets[2 * a] : 0;
        offs.dc[a] = a < n_angles ? offsets[2 * a + 1] : 0;
    }
    // a table that fits SPAN_TABLE_BYTES takes one 512-thread block, two an
    // SM; a larger one two blocks of SPAN_THREADS, each holding half
    const int Lp = levels | 1;
    const int ncta =
        (size_t)levels * Lp * sizeof(int) <= SPAN_TABLE_BYTES ? 1 : 2;
    const int threads = ncta == 1 ? SPAN_THREADS / 2 : SPAN_THREADS;
    const int rows = (levels + ncta - 1) / ncta;
    const size_t smem = ((size_t)rows * Lp + SPAN_CELLS) * sizeof(int);
    int clusters = 0;
    cudaError_t err = spanner_grid(levels, ncta, threads, smem, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters > M * n_angles) clusters = (int)(M * n_angles);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)(clusters * ncta), 1, 1);
    cfg.blockDim = dim3((unsigned int)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, glcm_spanner_hist_kernel, (const long long*)lab_base,
        (const long long*)img_base, n_shards, (int)H, (int)W, (int)C, band,
        (const int32_t*)ids, (const int32_t*)piece_ptr,
        (const int32_t*)pieces, (const float*)mn, (const float*)inv, K,
        levels, rows, offs, M, n_angles, (int*)tables, (long long*)sumsq);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
