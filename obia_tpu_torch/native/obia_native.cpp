// The port's host-side native runtime (a copy of the functions of
// obia_tpu/native/src/obia_native.cpp that obia_tpu_torch calls): sparse
// union-find component resolution (the sharded CCL's seam merge) and the
// scanline polygoniser over row-wise RLE labels with its packed export.
//
// Exposed with a plain C ABI for ctypes binding (obia_tpu_torch/native);
// built at first use with `g++ -O3 -std=c++17 -shared -fPIC`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Resolve per-pixel component ids through a sparse union-find keyed by the
// component values themselves (values may be large/global linear indices).
// comp: n pixel component ids (-1 = invalid, left unchanged).
// pairs (a, b): equivalences between component VALUES.
// out: resolved root id per pixel.
// ---------------------------------------------------------------------------
void resolve_components(const int64_t* comp, int64_t n,
                        const int64_t* a, const int64_t* b, int64_t n_pairs,
                        int64_t* out) {
    std::unordered_map<int64_t, int64_t> parent;
    parent.reserve(static_cast<size_t>(n_pairs) * 2 + 16);

    std::vector<int64_t> stack;
    auto find = [&](int64_t x) -> int64_t {
        int64_t root = x;
        for (;;) {
            auto it = parent.find(root);
            if (it == parent.end() || it->second == root) break;
            root = it->second;
        }
        // path compression
        while (x != root) {
            auto it = parent.find(x);
            int64_t next = (it == parent.end()) ? root : it->second;
            parent[x] = root;
            if (next == x) break;
            x = next;
        }
        return root;
    };

    for (int64_t i = 0; i < n_pairs; ++i) {
        int64_t x = a[i], y = b[i];
        if (x < 0 || y < 0) continue;
        int64_t rx = find(x);
        int64_t ry = find(y);
        if (rx == ry) continue;
        if (rx < ry) parent[ry] = rx; else parent[rx] = ry;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = comp[i];
        out[i] = (c < 0) ? -1 : find(c);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Polygonizer: label raster -> rectilinear rings (pixel-corner coords).
// The algorithm of the reference's numpy polygoniser
// (obia_tpu/geometry/polygonize.py: right-turn-first ring stitching,
// 4-connectivity semantics). Two-phase C ABI via an opaque handle.
// ---------------------------------------------------------------------------

namespace {

struct Ring {
    int64_t label;
    std::vector<double> xy;  // x0,y0,x1,y1,... closed (first == last)
    double signed_area;
};

struct PolyResult {
    std::vector<Ring> rings;
};

// Directions: 0=E(+x), 1=S(+y), 2=W(-x), 3=N(-y); right turn = (d+1)%4.
static const int DSTEP_X[4] = {1, 0, -1, 0};
static const int DSTEP_Y[4] = {0, 1, 0, -1};

static double ring_signed_area(const std::vector<double>& xy) {
    double a = 0.0;
    size_t n = xy.size() / 2;
    for (size_t i = 0; i + 1 < n; ++i) {
        a += xy[2 * i] * xy[2 * i + 3] - xy[2 * i + 2] * xy[2 * i + 1];
    }
    return 0.5 * a;
}

static void simplify_collinear(std::vector<double>& xy) {
    size_t n = xy.size() / 2;
    if (n < 4) return;
    std::vector<double> out;
    out.reserve(xy.size());
    // points 0..n-2 are unique (last == first)
    size_t m = n - 1;
    for (size_t i = 0; i < m; ++i) {
        size_t p = (i + m - 1) % m;
        size_t q = (i + 1) % m;
        double px = xy[2 * p], py = xy[2 * p + 1];
        double cx = xy[2 * i], cy = xy[2 * i + 1];
        double nx = xy[2 * q], ny = xy[2 * q + 1];
        bool collinear = (px == cx && cx == nx) || (py == cy && cy == ny);
        if (!collinear) {
            out.push_back(cx);
            out.push_back(cy);
        }
    }
    if (out.size() >= 6) {
        out.push_back(out[0]);
        out.push_back(out[1]);
        xy.swap(out);
    }
}

}  // namespace

namespace {

struct Edge { int64_t label; int64_t corner; int8_t dir; };

PolyResult* stitch_edges(std::vector<Edge>& edges, int64_t CW, int simplify);

}  // namespace


extern "C" {

// RLE input: runs break at row ends (values/lengths per run). Edge
// collection is O(runs + boundary pixels) instead of O(pixels) — the
// label raster never needs densifying on the (throttled) host.
void* polygonize_build_rle(const int32_t* values, const int32_t* lengths,
                           int64_t R, int64_t H, int64_t W, int simplify) {
    const int64_t CW = W + 1;
    std::vector<Edge> edges;
    edges.reserve(static_cast<size_t>(R) * 6);
    std::vector<int64_t> row_first(H + 1, R);
    std::vector<int64_t> run_c0(R, 0);
    {
        int64_t r = 0, c = 0;
        row_first[0] = 0;
        for (int64_t i = 0; i < R && r < H; ++i) {
            run_c0[i] = c;
            c += lengths[i];
            if (c >= W) { ++r; if (r <= H) row_first[r] = i + 1; c = 0; }
        }
    }
    // horizontal (N/S) edges: two-pointer merge of a row against the row
    // above/below; per differing overlap, one unit edge per column
    auto h_edges = [&](int64_t r, int64_t q, int dir) {
        int64_t i = row_first[r], iend = row_first[r + 1];
        int64_t j = (q >= 0 && q < H) ? row_first[q] : -1;
        int64_t jend = (q >= 0 && q < H) ? row_first[q + 1] : -1;
        while (i < iend) {
            int32_t v = values[i];
            int64_t a0 = run_c0[i], a1 = a0 + lengths[i];
            if (v < 0) { ++i; continue; }
            if (j < 0) {  // border row: edge across the whole run
                for (int64_t c = a0; c < a1; ++c)
                    edges.push_back(dir == 0
                        ? Edge{v, r * CW + c, 0}
                        : Edge{v, (r + 1) * CW + c + 1, 2});
                ++i; continue;
            }
            // advance j to the first other-row run overlapping [a0, a1)
            while (j < jend && run_c0[j] + lengths[j] <= a0) ++j;
            int64_t jj = j;
            while (jj < jend && run_c0[jj] < a1) {
                int64_t b0 = std::max<int64_t>(a0, run_c0[jj]);
                int64_t b1 = std::min<int64_t>(a1, run_c0[jj] + lengths[jj]);
                if (values[jj] != v) {
                    for (int64_t c = b0; c < b1; ++c)
                        edges.push_back(dir == 0
                            ? Edge{v, r * CW + c, 0}
                            : Edge{v, (r + 1) * CW + c + 1, 2});
                }
                ++jj;
            }
            ++i;
        }
    };
    for (int64_t r = 0; r < H; ++r) {
        h_edges(r, r - 1, 0);  // N edges
        h_edges(r, r + 1, 2);  // S edges
        // vertical (E/W) edges: one per run side
        for (int64_t i = row_first[r]; i < row_first[r + 1]; ++i) {
            int32_t v = values[i];
            if (v < 0) continue;
            int64_t c0 = run_c0[i], c1 = c0 + lengths[i];
            int32_t left = (c0 == 0) ? -9 : values[i - 1];
            int32_t right = (c1 >= W) ? -9 : values[i + 1];
            if (left != v)
                edges.push_back({v, (r + 1) * CW + c0, 3});   // W edge
            if (right != v)
                edges.push_back({v, r * CW + c1, 1});         // E edge
        }
    }
    return stitch_edges(edges, CW, simplify);
}

}  // extern "C"

namespace {

PolyResult* stitch_edges(std::vector<Edge>& edges, int64_t CW,
                         int simplify) {
    std::stable_sort(edges.begin(), edges.end(),
                     [](const Edge& a, const Edge& b) {
                         if (a.label != b.label) return a.label < b.label;
                         return a.corner < b.corner;
                     });

    auto* result = new PolyResult();
    size_t i = 0;
    std::unordered_map<int64_t, uint8_t> out_dirs;  // corner -> dir bitmask
    while (i < edges.size()) {
        int64_t label = edges[i].label;
        size_t j = i;
        out_dirs.clear();
        while (j < edges.size() && edges[j].label == label) {
            out_dirs[edges[j].corner] |= (1u << edges[j].dir);
            ++j;
        }
        // walk rings: iterate start corners in ascending order (edges are
        // sorted by corner within the label)
        for (size_t e = i; e < j; ++e) {
            int64_t s0 = edges[e].corner;
            auto it0 = out_dirs.find(s0);
            if (it0 == out_dirs.end() || it0->second == 0) continue;
            while (it0->second) {
                // take HIGHEST available direction at the seed (matches
                // the Python reference, so ring order is identical even
                // at pinch corners with two outgoing edges)
                int d = 31 - __builtin_clz(it0->second);
                it0->second &= ~(1u << d);
                Ring ring;
                ring.label = label;
                auto push_corner = [&](int64_t corner) {
                    ring.xy.push_back(static_cast<double>(corner % CW));
                    ring.xy.push_back(static_cast<double>(corner / CW));
                };
                push_corner(s0);
                int64_t cur = s0;
                int cur_d = d;
                for (;;) {
                    int64_t nxt = cur + DSTEP_Y[cur_d] * CW + DSTEP_X[cur_d];
                    push_corner(nxt);
                    if (nxt == s0) break;
                    auto it = out_dirs.find(nxt);
                    if (it == out_dirs.end() || it->second == 0) break;
                    int chosen = -1;
                    for (int turn : {1, 0, 3}) {  // right, straight, left
                        int dd = (cur_d + turn) & 3;
                        if (it->second & (1u << dd)) { chosen = dd; break; }
                    }
                    if (chosen < 0) chosen = __builtin_ctz(it->second);
                    it->second &= ~(1u << chosen);
                    cur = nxt;
                    cur_d = chosen;
                }
                if (simplify) simplify_collinear(ring.xy);
                ring.signed_area = ring_signed_area(ring.xy);
                result->rings.push_back(std::move(ring));
                it0 = out_dirs.find(s0);
                if (it0 == out_dirs.end()) break;
            }
        }
        i = j;
    }
    return result;
}

}  // namespace

extern "C" {

int64_t polygonize_num_rings(void* h) {
    return static_cast<PolyResult*>(h)->rings.size();
}

void polygonize_free(void* h) {
    delete static_cast<PolyResult*>(h);
}

int64_t polygonize_total_pts(void* h) {
    int64_t total = 0;
    for (const Ring& r : static_cast<PolyResult*>(h)->rings)
        total += static_cast<int64_t>(r.xy.size() / 2);
    return total;
}

// Batch export: one call fills per-ring labels/sizes/areas and the
// concatenated coords — the per-ring C-ABI round trips (3 calls + one
// numpy alloc per ring) dominated collection at 50k+ tiny objects.
void polygonize_export(void* h, int64_t* labels, int64_t* n_pts,
                       double* areas, double* xy) {
    PolyResult* pr = static_cast<PolyResult*>(h);
    double* out = xy;
    for (size_t i = 0; i < pr->rings.size(); ++i) {
        const Ring& r = pr->rings[i];
        labels[i] = r.label;
        n_pts[i] = static_cast<int64_t>(r.xy.size() / 2);
        areas[i] = r.signed_area;
        std::memcpy(out, r.xy.data(), r.xy.size() * sizeof(double));
        out += r.xy.size();
    }
}

}  // extern "C"
