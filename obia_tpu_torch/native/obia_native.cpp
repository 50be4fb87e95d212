// The port's host-side native runtime (a copy of the functions of
// obia_tpu/native/src/obia_native.cpp that obia_tpu_torch calls): sparse
// union-find component resolution (the sharded CCL's seam merge), the
// scanline polygoniser over row-wise RLE labels with its packed export, and
// path-dependent TreeSHAP for the random forest of classify().
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

// ---------------------------------------------------------------------------
// TreeSHAP (path-dependent, Lundberg et al. 2018) for dense-array decision
// trees, in place of shap.TreeExplainer on random forests (the shap
// package is not a dependency). Trees arrive in a dense layout:
// feature[n] (-1 = leaf), threshold[n], left[n], right[n] (self-loop at
// leaves), values[n * n_classes] (leaf distributions), node_sample_weight
// (cover) [n].
// phi has shape (n_samples, n_features + 1, n_classes); the last feature
// slot accumulates the expected value (bias) per sample.
// ---------------------------------------------------------------------------

namespace treeshap {

struct PathElem {
    int feature_index;
    double zero_fraction;
    double one_fraction;
    double pweight;
};

struct Ctx {
    const int32_t* feature;
    const double* threshold;
    const int32_t* left;
    const int32_t* right;
    const double* values;       // (n_nodes, n_classes)
    const double* cover;        // (n_nodes,)
    int n_classes;
    const double* x;            // one sample (n_features,)
    double* phi;                // (n_features + 1, n_classes)
    int n_features;
};

static void extend_path(PathElem* path, int depth, double zero, double one,
                        int fi) {
    path[depth].feature_index = fi;
    path[depth].zero_fraction = zero;
    path[depth].one_fraction = one;
    path[depth].pweight = depth == 0 ? 1.0 : 0.0;
    for (int i = depth - 1; i >= 0; --i) {
        path[i + 1].pweight += one * path[i].pweight * (i + 1)
                               / static_cast<double>(depth + 1);
        path[i].pweight = zero * path[i].pweight * (depth - i)
                          / static_cast<double>(depth + 1);
    }
}

static void unwind_path(PathElem* path, int depth, int index) {
    const double one = path[index].one_fraction;
    const double zero = path[index].zero_fraction;
    double next = path[depth].pweight;
    for (int i = depth - 1; i >= 0; --i) {
        if (one != 0) {
            const double tmp = path[i].pweight;
            path[i].pweight = next * (depth + 1)
                              / (static_cast<double>(i + 1) * one);
            next = tmp - path[i].pweight * zero * (depth - i)
                         / static_cast<double>(depth + 1);
        } else {
            path[i].pweight = path[i].pweight * (depth + 1)
                              / (zero * (depth - i));
        }
    }
    for (int i = index; i < depth; ++i) {
        path[i].feature_index = path[i + 1].feature_index;
        path[i].zero_fraction = path[i + 1].zero_fraction;
        path[i].one_fraction = path[i + 1].one_fraction;
    }
}

static double unwound_sum(const PathElem* path, int depth, int index) {
    const double one = path[index].one_fraction;
    const double zero = path[index].zero_fraction;
    double next = path[depth].pweight;
    double total = 0.0;
    for (int i = depth - 1; i >= 0; --i) {
        if (one != 0) {
            const double tmp = next * (depth + 1)
                               / (static_cast<double>(i + 1) * one);
            total += tmp;
            next = path[i].pweight - tmp * zero * (depth - i)
                                     / static_cast<double>(depth + 1);
        } else {
            total += path[i].pweight / (zero * (depth - i)
                                        / static_cast<double>(depth + 1));
        }
    }
    return total;
}

static void recurse(Ctx& c, int node, PathElem* parent_path, int depth,
                    double zero, double one, int pi) {
    // copy parent path
    PathElem* path = parent_path + depth + 1;  // contiguous scratch layout
    std::memcpy(path, parent_path, sizeof(PathElem) * (depth > 0 ? depth : 0));
    extend_path(path, depth, zero, one, pi);

    const bool is_leaf = c.feature[node] < 0;
    if (is_leaf) {
        for (int i = 1; i <= depth; ++i) {
            const double w = unwound_sum(path, depth, i);
            const PathElem& el = path[i];
            const double scale = w * (el.one_fraction - el.zero_fraction);
            const double* v = c.values + static_cast<size_t>(node) * c.n_classes;
            double* out = c.phi + static_cast<size_t>(el.feature_index)
                                  * c.n_classes;
            for (int k = 0; k < c.n_classes; ++k) out[k] += scale * v[k];
        }
        return;
    }

    const int f = c.feature[node];
    const int l = c.left[node];
    const int r = c.right[node];
    const int hot = (c.x[f] <= c.threshold[node]) ? l : r;
    const int cold = (hot == l) ? r : l;
    const double cover_node = c.cover[node];
    const double rh = c.cover[hot] / cover_node;
    const double rc = c.cover[cold] / cover_node;

    double iz = 1.0, io = 1.0;
    int k = 0;
    for (; k <= depth; ++k) {
        if (path[k].feature_index == f) break;
    }
    int new_depth = depth;
    if (k <= depth) {
        iz = path[k].zero_fraction;
        io = path[k].one_fraction;
        unwind_path(path, depth, k);
        new_depth = depth - 1;
    }
    recurse(c, hot, path, new_depth + 1, iz * rh, io, f);
    recurse(c, cold, path, new_depth + 1, iz * rc, 0.0, f);
}

}  // namespace treeshap

extern "C" {

void tree_shap(const int32_t* feature, const double* threshold,
               const int32_t* left, const int32_t* right,
               const double* values, const double* cover,
               int64_t n_nodes, int32_t n_classes, int32_t n_features,
               const double* X, int64_t n_samples,
               double* phi /* (n_samples, n_features + 1, n_classes) */,
               int32_t max_depth) {
    const int scratch = (max_depth + 2) * (max_depth + 2);
    std::vector<treeshap::PathElem> path(scratch);
    for (int64_t s = 0; s < n_samples; ++s) {
        treeshap::Ctx c{feature, threshold, left, right, values, cover,
                        n_classes, X + s * n_features,
                        phi + s * static_cast<size_t>(n_features + 1)
                            * n_classes,
                        n_features};
        // bias slot (phi[:, n_features, :]): the tree's expected value =
        // the ROOT node's (normalised) class distribution; with it, the
        // per-tree phi satisfies bias + sum(phi) == leaf prediction. (The
        // Python wrapper slices the slot off and recomputes the forest
        // base itself; direct C callers get the documented contract.)
        for (int32_t k = 0; k < n_classes; ++k)
            c.phi[static_cast<size_t>(n_features) * n_classes + k] +=
                values[k];
        std::memset(path.data(), 0, sizeof(treeshap::PathElem) * scratch);
        treeshap::recurse(c, 0, path.data(), 0, 1.0, 1.0, -1);
    }
}

}  // extern "C"
