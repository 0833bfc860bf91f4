// hostops: the port's native host-side post-processing, in C++.
//
// An own copy of the JAX package's native/hostops.cpp. Case evaluation keeps
// the largest face-connected component of every predicted case volume on
// every epoch, on the host; this is a flat union-find over the voxel grid
// (4 neighbours in 2D, 6 in 3D) with one relabel pass, with no Python
// object per region.
//
// Tie rule: where several components share the largest size, the kept one
// is the first whose running count, in raster order, reaches that size
// (the component whose last voxel comes first);
// ops/cc.py::keep_largest_connected_components_plain is the same function
// in numpy over scipy.ndimage.label.
//
// Build: g++ -O3 -shared -fPIC hostops.cpp -o libhostops.so
// (aide_tpu_torch/native/__init__.py builds it at first use and binds it
// with ctypes).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;

  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }

  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
};

}  // namespace

extern "C" {

// Keep only the largest face-connected foreground component of a
// (depth, height, width) uint8 volume (depth == 1 covers the 2D case).
// Writes 0/1 into `out` (may alias `mask`). Returns the number of
// foreground components found. The voxel count must be below 2^31.
int32_t keep_largest_cc(const uint8_t* mask, int32_t depth, int32_t height,
                        int32_t width, uint8_t* out) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t n = static_cast<int64_t>(depth) * plane;

  UnionFind uf(static_cast<size_t>(n));
  // union with the already-visited face neighbours (-x, -y, -z)
  for (int32_t z = 0; z < depth; ++z) {
    for (int32_t y = 0; y < height; ++y) {
      const int64_t row = static_cast<int64_t>(z) * plane +
                          static_cast<int64_t>(y) * width;
      for (int32_t x = 0; x < width; ++x) {
        const int64_t i = row + x;
        if (!mask[i]) continue;
        if (x > 0 && mask[i - 1]) uf.unite(static_cast<int32_t>(i - 1),
                                           static_cast<int32_t>(i));
        if (y > 0 && mask[i - width]) uf.unite(static_cast<int32_t>(i - width),
                                               static_cast<int32_t>(i));
        if (z > 0 && mask[i - plane]) uf.unite(static_cast<int32_t>(i - plane),
                                               static_cast<int32_t>(i));
      }
    }
  }

  // component sizes keyed by root
  std::vector<int64_t> size(static_cast<size_t>(n), 0);
  int64_t best_root = -1;
  int64_t best_size = 0;
  int32_t n_components = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    const int32_t r = uf.find(static_cast<int32_t>(i));
    if (size[r] == 0) ++n_components;
    if (++size[r] > best_size) {
      best_size = size[r];
      best_root = r;
    }
  }

  if (best_root < 0) {
    std::memset(out, 0, static_cast<size_t>(n));
    return 0;
  }
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (mask[i] && uf.find(static_cast<int32_t>(i)) == best_root) ? 1 : 0;
  }
  return n_components;
}

// Confusion counts (TP, TN, FP, FN) between two binary uint8 volumes of n
// voxels each.
void volume_confusion(const uint8_t* pred, const uint8_t* target, int64_t n,
                      int64_t* out_tp, int64_t* out_tn, int64_t* out_fp,
                      int64_t* out_fn) {
  int64_t tp = 0, tn = 0, fp = 0, fn = 0;
  for (int64_t i = 0; i < n; ++i) {
    const bool p = pred[i] != 0;
    const bool t = target[i] != 0;
    tp += p & t;
    tn += (!p) & (!t);
    fp += p & (!t);
    fn += (!p) & t;
  }
  *out_tp = tp;
  *out_tn = tn;
  *out_fp = fp;
  *out_fn = fn;
}

}  // extern "C"
