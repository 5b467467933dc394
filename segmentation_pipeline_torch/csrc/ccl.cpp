// Native connected-component labeling + morphology for 3D label volumes.
//
// The reference delegates these to scikit-image's C internals
// (post_processing.py:1, instance_segmentation_evaluator.py:4); this is the
// framework-owned native equivalent: a RUN-BASED two-pass union-find labeler
// with 6/18/26-connectivity and a cross-footprint grey dilation, exposed via
// a C ABI for ctypes.  Outputs match scipy.ndimage exactly (labels numbered
// by first occurrence in C order) — verified by tests/test_torch_native.py.
//
// Copied from segmentation_pipeline_tpu/native/ccl.cpp. Built at first use
// by segmentation_pipeline_torch/native.py (g++ -O3 -shared -fPIC) into
// build/torch_kernels/, keyed by a hash of this source.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;

    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }

    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int32_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;
    }
};

// "previous" neighbor offsets in C-order (W slowest, D fastest) for a given
// connectivity (1=6, 2=18, 3=26 neighborhood).
static int build_prev_offsets(int connectivity, int offsets[13][3]) {
    int n = 0;
    for (int dw = -1; dw <= 1; ++dw) {
        for (int dh = -1; dh <= 1; ++dh) {
            for (int dd = -1; dd <= 1; ++dd) {
                if (dw == 0 && dh == 0 && dd == 0) continue;
                int manhattan = (dw != 0) + (dh != 0) + (dd != 0);
                if (manhattan > connectivity) continue;
                // keep only lexicographically-previous neighbors
                if (dw > 0) continue;
                if (dw == 0 && dh > 0) continue;
                if (dw == 0 && dh == 0 && dd > 0) continue;
                offsets[n][0] = dw;
                offsets[n][1] = dh;
                offsets[n][2] = dd;
                ++n;
            }
        }
    }
    return n;
}

}  // namespace

extern "C" {

// Label foreground (img != 0) components of a (W, H, D) C-order volume.
// Returns the number of components; writes labels 1..N into out.
//
// Run-based two-pass union-find: pass 1 compresses each (w, h) column into
// foreground runs along D and unions runs against the overlapping runs of
// the (up to 4) lexicographically-previous neighbor columns with a
// two-pointer interval sweep, so union work scales with the number of RUNS,
// not voxels.  Pass 2 renumbers roots by first occurrence in C order (run
// order == first-voxel order), matching scipy.ndimage.label exactly.
int32_t label_components(const uint8_t* img, int32_t* out,
                         int64_t W, int64_t H, int64_t D, int connectivity) {
    const int64_t n_cols = W * H;

    // runs: flat arrays, indexed per column via col_start/col_count
    std::vector<int32_t> run_d0, run_d1;
    std::vector<int64_t> col_start(n_cols);
    std::vector<int32_t> col_count(n_cols);

    run_d0.reserve(1 << 16);
    run_d1.reserve(1 << 16);
    for (int64_t c = 0; c < n_cols; ++c) {
        const uint8_t* col = img + c * D;
        col_start[c] = static_cast<int64_t>(run_d0.size());
        int32_t cnt = 0;
        int64_t d = 0;
        while (d < D) {
            // skip background 8 bytes at a time (sparse masks are mostly 0)
            while (d + 8 <= D) {
                uint64_t v;
                std::memcpy(&v, col + d, 8);
                if (v) break;
                d += 8;
            }
            if (d >= D) break;
            if (!col[d]) { ++d; continue; }
            const int64_t d0 = d;
            while (d < D && col[d]) ++d;
            run_d0.push_back(static_cast<int32_t>(d0));
            run_d1.push_back(static_cast<int32_t>(d));
            ++cnt;
        }
        col_count[c] = cnt;
    }
    const int64_t n_runs = static_cast<int64_t>(run_d0.size());
    if (n_runs == 0) {
        std::memset(out, 0, sizeof(int32_t) * W * H * D);
        return 0;
    }

    UnionFind uf(static_cast<size_t>(n_runs));

    // previous-neighbor columns: (dw, dh, d-dilation) for this connectivity
    int ncols_prev = 0;
    int prev_dw[4], prev_dh[4], prev_dil[4];
    {
        struct { int dw, dh; } cand[4] = {{0, -1}, {-1, -1}, {-1, 0}, {-1, 1}};
        for (int k = 0; k < 4; ++k) {
            const int manhattan = (cand[k].dw != 0) + (cand[k].dh != 0);
            if (manhattan > connectivity) continue;  // column not a neighbor
            prev_dw[ncols_prev] = cand[k].dw;
            prev_dh[ncols_prev] = cand[k].dh;
            prev_dil[ncols_prev] = (manhattan + 1 <= connectivity) ? 1 : 0;
            ++ncols_prev;
        }
    }

    for (int64_t w = 0; w < W; ++w) {
        for (int64_t h = 0; h < H; ++h) {
            const int64_t c = w * H + h;
            const int32_t cnt = col_count[c];
            if (!cnt) continue;
            const int64_t base = col_start[c];
            for (int k = 0; k < ncols_prev; ++k) {
                const int64_t nw = w + prev_dw[k];
                const int64_t nh = h + prev_dh[k];
                if (nw < 0 || nh < 0 || nh >= H) continue;
                const int64_t nc = nw * H + nh;
                const int32_t ncnt = col_count[nc];
                if (!ncnt) continue;
                const int64_t nbase = col_start[nc];
                const int t = prev_dil[k];
                // two-pointer sweep over sorted, disjoint runs
                int32_t i = 0, j = 0;
                while (i < cnt && j < ncnt) {
                    const int32_t a0 = run_d0[base + i], a1 = run_d1[base + i];
                    const int32_t b0 = run_d0[nbase + j], b1 = run_d1[nbase + j];
                    if (a0 < b1 + t && b0 < a1 + t)
                        uf.unite(static_cast<int32_t>(base + i),
                                 static_cast<int32_t>(nbase + j));
                    // advance the run that ends first: safe for t <= 1
                    // because maximal runs are separated by >= 1 gap
                    if (a1 <= b1) ++i; else ++j;
                }
            }
        }
    }

    // pass 2: renumber roots by first occurrence in run (C) order and fill
    std::vector<int32_t> remap(n_runs, 0);
    int32_t count = 0;
    std::memset(out, 0, sizeof(int32_t) * W * H * D);
    for (int64_t c = 0; c < n_cols; ++c) {
        const int64_t base = col_start[c];
        const int32_t cnt = col_count[c];
        int32_t* ocol = out + c * D;
        for (int32_t i = 0; i < cnt; ++i) {
            const int32_t root = uf.find(static_cast<int32_t>(base + i));
            int32_t lab = remap[root];
            if (lab == 0) { lab = ++count; remap[root] = lab; }
            const int32_t d0 = run_d0[base + i], d1 = run_d1[base + i];
            for (int32_t d = d0; d < d1; ++d) ocol[d] = lab;
        }
    }
    return count;
}

// Grey dilation with the 6-neighborhood cross footprint (+ center), matching
// scipy.ndimage.grey_dilation(footprint=generate_binary_structure(3, 1)).
void grey_dilate_cross(const int32_t* img, int32_t* out,
                       int64_t W, int64_t H, int64_t D) {
    for (int64_t w = 0; w < W; ++w) {
        for (int64_t h = 0; h < H; ++h) {
            const int64_t base = (w * H + h) * D;
            for (int64_t d = 0; d < D; ++d) {
                const int64_t idx = base + d;
                int32_t m = img[idx];
                if (w > 0)      m = std::max(m, img[idx - H * D]);
                if (w < W - 1)  m = std::max(m, img[idx + H * D]);
                if (h > 0)      m = std::max(m, img[idx - D]);
                if (h < H - 1)  m = std::max(m, img[idx + D]);
                if (d > 0)      m = std::max(m, img[idx - 1]);
                if (d < D - 1)  m = std::max(m, img[idx + 1]);
                out[idx] = m;
            }
        }
    }
}

// Component voxel counts: out_counts must have space for (num_labels + 1).
void component_counts(const int32_t* labels, int64_t n,
                      int64_t* out_counts, int32_t num_labels) {
    std::memset(out_counts, 0, sizeof(int64_t) * (num_labels + 1));
    for (int64_t i = 0; i < n; ++i) {
        const int32_t lab = labels[i];
        if (lab >= 0 && lab <= num_labels) ++out_counts[lab];
    }
}

}  // extern "C"

// Joint confusion histogram for segmentation metrics: one streaming pass
// over int32 target/pred label maps. lut maps raw value -> dense index in
// [0, L] (bucket L = "not a named label"); values outside [0, lut_len)
// clamp into bucket L. counts: (L+1)*(L+1) int64, zeroed by the caller.
extern "C" void confusion_joint_hist(const int32_t* target,
                                     const int32_t* pred,
                                     int64_t n,
                                     const int32_t* lut, int64_t lut_len,
                                     int32_t L,
                                     int64_t* counts) {
    const int64_t stride = (int64_t)L + 1;
    for (int64_t i = 0; i < n; ++i) {
        int32_t t = target[i];
        int32_t p = pred[i];
        int32_t ti = (t >= 0 && t < lut_len) ? lut[t] : L;
        int32_t pi = (p >= 0 && p < lut_len) ? lut[p] : L;
        counts[(int64_t)ti * stride + pi]++;
    }
}
