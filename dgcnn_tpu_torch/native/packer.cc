// Native epoch packer — the host-side runtime component.
//
// Role: the batch-collation hot path that PyG delegates to its C++
// DataLoader/collate machinery (reference train.py:108-109) and that the
// COO layout needs every epoch (the dense layout gathers on device and
// needs no host packing). The NumPy implementation in batching/packer.py
// is the semantic reference; this is a drop-in accelerated backend loaded
// through ctypes (native/__init__.py), byte-for-byte identical output
// (tests/test_native.py).
//
// Layout contract (must match batching/packer.py pack_epoch):
//   * graphs of each batch are consecutive `batch_size` slices of `order`
//   * node features copied per graph, node_graph = slot id, padding slots
//     carry node_graph == b_pad and zero features
//   * self-loops stripped; edges destination-sorted per batch (stable:
//     source order preserved within a destination via counting sort)
//   * padded edges: src 0, dst n_pad-1 (keeps the dst column sorted),
//     mask 0
//
// Build: native/__init__.py shells out to g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Packs one epoch. Returns 0 on success, negative error codes otherwise.
//   -1: a batch exceeds the node bucket   -2: exceeds the edge bucket
//   -3: exceeds the graph-slot bucket
int dgcnn_pack_epoch_coo(
    // dataset arrays (GraphSet layout)
    const float* x, int64_t num_features,
    const int64_t* node_ptr,
    const int32_t* edge_src, const int32_t* edge_dst, const int64_t* edge_ptr,
    const int32_t* y,
    // epoch order and batching
    const int64_t* order, int64_t num_order, int64_t batch_size,
    // bucket shape
    int64_t n_pad, int64_t e_pad, int64_t b_pad,
    // outputs, preallocated with a leading steps axis, NOT pre-zeroed
    float* out_x,          // [steps, n_pad, F]
    int32_t* out_src,      // [steps, e_pad]
    int32_t* out_dst,      // [steps, e_pad]
    float* out_emask,      // [steps, e_pad]
    int32_t* out_ngraph,   // [steps, n_pad]
    float* out_nmask,      // [steps, n_pad]
    int32_t* out_y,        // [steps, b_pad]
    float* out_gmask,      // [steps, b_pad]
    int32_t* out_ngraphs   // [steps]
) {
  const int64_t steps = (num_order + batch_size - 1) / batch_size;

  // scratch: per-batch unsorted edges and counting-sort bookkeeping
  std::vector<int32_t> tmp_src(static_cast<size_t>(e_pad));
  std::vector<int32_t> tmp_dst(static_cast<size_t>(e_pad));
  std::vector<int64_t> dst_count(static_cast<size_t>(n_pad) + 1);

  for (int64_t s = 0; s < steps; ++s) {
    const int64_t g0 = s * batch_size;
    const int64_t g1 = (g0 + batch_size < num_order) ? g0 + batch_size : num_order;
    const int64_t b = g1 - g0;
    if (b > b_pad) return -3;

    float* bx = out_x + s * n_pad * num_features;
    int32_t* bsrc = out_src + s * e_pad;
    int32_t* bdst = out_dst + s * e_pad;
    float* bem = out_emask + s * e_pad;
    int32_t* bng = out_ngraph + s * n_pad;
    float* bnm = out_nmask + s * n_pad;
    int32_t* by = out_y + s * b_pad;
    float* bgm = out_gmask + s * b_pad;

    // nodes: copy features, assign slots
    int64_t node_off = 0;
    int64_t edge_cnt = 0;
    for (int64_t j = 0; j < b; ++j) {
      const int64_t g = order[g0 + j];
      const int64_t ns = node_ptr[g], ne = node_ptr[g + 1];
      const int64_t n = ne - ns;
      if (node_off + n > n_pad) return -1;
      std::memcpy(bx + node_off * num_features, x + ns * num_features,
                  static_cast<size_t>(n * num_features) * sizeof(float));
      for (int64_t i = 0; i < n; ++i) bng[node_off + i] = static_cast<int32_t>(j);

      const int64_t es = edge_ptr[g], ee = edge_ptr[g + 1];
      for (int64_t e = es; e < ee; ++e) {
        const int32_t a = edge_src[e], d = edge_dst[e];
        if (a == d) continue;  // strip self-loops (reference model.py:28)
        if (edge_cnt >= e_pad) return -2;
        tmp_src[edge_cnt] = static_cast<int32_t>(a + node_off);
        tmp_dst[edge_cnt] = static_cast<int32_t>(d + node_off);
        ++edge_cnt;
      }
      node_off += n;
    }

    // node padding
    std::memset(bx + node_off * num_features, 0,
                static_cast<size_t>((n_pad - node_off) * num_features) * sizeof(float));
    for (int64_t i = 0; i < node_off; ++i) bnm[i] = 1.0f;
    for (int64_t i = node_off; i < n_pad; ++i) {
      bnm[i] = 0.0f;
      bng[i] = static_cast<int32_t>(b_pad);
    }

    // stable counting sort of edges by destination
    std::memset(dst_count.data(), 0, (static_cast<size_t>(n_pad) + 1) * sizeof(int64_t));
    for (int64_t e = 0; e < edge_cnt; ++e) ++dst_count[tmp_dst[e] + 1];
    for (int64_t i = 0; i < n_pad; ++i) dst_count[i + 1] += dst_count[i];
    for (int64_t e = 0; e < edge_cnt; ++e) {
      const int64_t pos = dst_count[tmp_dst[e]]++;
      bsrc[pos] = tmp_src[e];
      bdst[pos] = tmp_dst[e];
      bem[pos] = 1.0f;
    }
    // edge padding: dst = n_pad-1 keeps the column sorted
    for (int64_t e = edge_cnt; e < e_pad; ++e) {
      bsrc[e] = 0;
      bdst[e] = static_cast<int32_t>(n_pad - 1);
      bem[e] = 0.0f;
    }

    // labels / graph slots
    for (int64_t j = 0; j < b; ++j) {
      by[j] = y[order[g0 + j]];
      bgm[j] = 1.0f;
    }
    for (int64_t j = b; j < b_pad; ++j) {
      by[j] = 0;
      bgm[j] = 0.0f;
    }
    out_ngraphs[s] = static_cast<int32_t>(b);
  }
  return 0;
}

}  // extern "C"
