// Native mesh-partitioning + halo-construction routines of the port.
//
// The host-side heavy lifting of domain decomposition — the role
// METIS/ParMETIS and Decomp's halo growth play in the reference
// (base/Decomp.cpp:968 partitioning; halo-layer BFS + exchange-list
// construction base/Decomp.cpp, base/Halo.cpp:455-600) — implemented
// natively for large meshes (10^6-10^7 cells) where the numpy path
// becomes init-time-dominant. The port's own copy of the JAX package's
// native/partition.cpp (same arithmetic, same results).
//
// Exposed as a plain C ABI consumed through ctypes
// (omega_tpu_torch/parallel/native.py). Four entry points:
//   omega_hilbert_keys      — Hilbert space-filling-curve keys from (x, y)
//   omega_partition_geom    — SFC sort + equal chunking -> owner per cell
//   omega_halo_layers       — BFS halo rings per shard, CSR output
//   omega_refine_partition  — greedy KL boundary refinement of an owner map
//
// Build: parallel/native.py runs `g++ -O3 -shared -fPIC -std=c++17` into
// omega_tpu_torch/build/ at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

// Map (x, y) in [0,1)^2 to a 2B-bit Hilbert curve index (B bits per axis).
// Classic quadrant-rotation formulation; better tail locality than Morton.
uint64_t hilbert_d2xy_key(uint32_t x, uint32_t y, int bits) {
  uint64_t rx, ry, d = 0;
  for (int64_t s = 1LL << (bits - 1); s > 0; s >>= 1) {
    rx = (x & s) > 0 ? 1 : 0;
    ry = (y & s) > 0 ? 1 : 0;
    d += static_cast<uint64_t>(s) * s * ((3 * rx) ^ ry);
    // rotate quadrant
    if (ry == 0) {
      if (rx == 1) {
        x = static_cast<uint32_t>(s - 1 - x);
        y = static_cast<uint32_t>(s - 1 - y);
      }
      std::swap(x, y);
    }
  }
  return d;
}

}  // namespace

extern "C" {

// Hilbert keys for n points; x, y must be pre-normalized to [0, 1).
void omega_hilbert_keys(const double* x, const double* y, int64_t n,
                        int bits, uint64_t* keys) {
  const double scale = static_cast<double>(1ULL << bits);
  for (int64_t i = 0; i < n; ++i) {
    double xi = x[i] - static_cast<int64_t>(x[i]);  // wrap periodic
    double yi = y[i] - static_cast<int64_t>(y[i]);
    if (xi < 0) xi += 1.0;
    if (yi < 0) yi += 1.0;
    uint32_t xq = static_cast<uint32_t>(
        std::min(xi * scale, scale - 1.0));
    uint32_t yq = static_cast<uint32_t>(
        std::min(yi * scale, scale - 1.0));
    keys[i] = hilbert_d2xy_key(xq, yq, bits);
  }
}

// Owner per cell: Hilbert-sort then cut into nparts equal chunks.
void omega_partition_geom(const double* x, const double* y, int64_t n,
                          int nparts, int bits, int64_t* owner) {
  std::vector<uint64_t> keys(n);
  omega_hilbert_keys(x, y, n, bits, keys.data());
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
  for (int64_t i = 0; i < n; ++i) {
    owner[order[i]] = static_cast<int64_t>(
        (static_cast<__int128>(i) * nparts) / n);
  }
}

// Grow `width` BFS halo rings per shard over the cell adjacency graph.
//
// cells_on_cell: (C, M) 0-based neighbor ids, -1 padding
// n_eoc:         (C,) valid neighbor counts
// owner:         (C,) owning shard per cell
// Output (caller-allocated):
//   out_cells:   capacity cap; receives, shard by shard, the local cell
//                list (owned cells in ascending global id, then halo ring
//                1 ascending, ring 2, ...)
//   out_offsets: (nparts * (width + 1) + 1); prefix offsets into
//                out_cells — per shard, [owned | ring1 | ... | ringW]
//                boundaries, flattened.
// Returns total cells written, or -(needed) if cap is too small.
int64_t omega_halo_layers(const int64_t* cells_on_cell,
                          const int32_t* n_eoc, int64_t C, int M,
                          const int64_t* owner, int nparts, int width,
                          int64_t* out_cells, int64_t cap,
                          int64_t* out_offsets) {
  std::vector<int32_t> mark(C);   // visit stamp per shard pass
  std::vector<int64_t> frontier, next, total_needed_v;
  int64_t pos = 0;
  int64_t needed = 0;
  int64_t off_idx = 0;
  out_offsets[off_idx++] = 0;

  // bucket owned cells per shard (ascending ids preserved by single pass)
  std::vector<std::vector<int64_t>> owned(nparts);
  for (int64_t c = 0; c < C; ++c) owned[owner[c]].push_back(c);

  for (int s = 0; s < nparts; ++s) {
    std::fill(mark.begin(), mark.end(), 0);
    const auto& own = owned[s];
    needed += static_cast<int64_t>(own.size());
    if (pos + static_cast<int64_t>(own.size()) <= cap) {
      std::memcpy(out_cells + pos, own.data(),
                  own.size() * sizeof(int64_t));
    }
    pos += static_cast<int64_t>(own.size());
    out_offsets[off_idx++] = pos;
    for (int64_t c : own) mark[c] = 1;

    frontier = own;
    for (int w = 0; w < width; ++w) {
      next.clear();
      for (int64_t c : frontier) {
        const int64_t* nbr = cells_on_cell + c * M;
        const int kn = n_eoc[c];
        for (int j = 0; j < kn; ++j) {
          int64_t b = nbr[j];
          if (b >= 0 && !mark[b]) {
            mark[b] = 1;
            next.push_back(b);
          }
        }
      }
      std::sort(next.begin(), next.end());
      needed += static_cast<int64_t>(next.size());
      if (pos + static_cast<int64_t>(next.size()) <= cap) {
        std::memcpy(out_cells + pos, next.data(),
                    next.size() * sizeof(int64_t));
      }
      pos += static_cast<int64_t>(next.size());
      out_offsets[off_idx++] = pos;
      frontier = next;
    }
  }
  return (needed <= cap) ? needed : -needed;
}

// Greedy Kernighan-Lin-style boundary refinement of a cell partition:
// sweep boundary cells, move each to the neighboring part with the best
// positive edge-cut gain subject to a balance band. The METIS-gap
// closer for the geometric SFC seed (base/Decomp.cpp:968 uses
// METIS_PartGraphKway; the SFC seed is already near-optimal on uniform
// meshes, refinement recovers most of the rest on variable-resolution
// ones). Returns the final edge cut.
int64_t omega_refine_partition(const int64_t* coc, const int32_t* n_eoc,
                               int64_t C, int M, int nparts, int passes,
                               double imbalance, int64_t* owner) {
  std::vector<int64_t> sizes(nparts, 0);
  for (int64_t c = 0; c < C; ++c) sizes[owner[c]]++;
  const double target = static_cast<double>(C) / nparts;
  const int64_t max_size =
      static_cast<int64_t>(target * (1.0 + imbalance)) + 1;
  const int64_t min_size =
      static_cast<int64_t>(target * (1.0 - imbalance));

  std::vector<int64_t> cnt(nparts, 0);
  std::vector<int> touched;
  for (int p = 0; p < passes; ++p) {
    int64_t moved = 0;
    for (int64_t c = 0; c < C; ++c) {
      const int64_t* nbr = coc + c * M;
      const int kn = n_eoc[c];
      touched.clear();
      for (int j = 0; j < kn; ++j) {
        int64_t b = nbr[j];
        if (b < 0) continue;
        int op = static_cast<int>(owner[b]);
        if (cnt[op] == 0) touched.push_back(op);
        cnt[op]++;
      }
      const int cur = static_cast<int>(owner[c]);
      int best = cur;
      int64_t best_gain = 0;
      for (int op : touched) {
        if (op == cur) continue;
        int64_t gain = cnt[op] - cnt[cur];
        if (gain > best_gain && sizes[op] < max_size &&
            sizes[cur] > min_size) {
          best_gain = gain;
          best = op;
        }
      }
      for (int op : touched) cnt[op] = 0;
      if (best != cur) {
        owner[c] = best;
        sizes[cur]--;
        sizes[best]++;
        moved++;
      }
    }
    if (moved == 0) break;
  }

  int64_t cut = 0;
  for (int64_t c = 0; c < C; ++c) {
    const int64_t* nbr = coc + c * M;
    const int kn = n_eoc[c];
    for (int j = 0; j < kn; ++j) {
      int64_t b = nbr[j];
      if (b >= 0 && owner[b] != owner[c]) cut++;
    }
  }
  return cut / 2;
}

}  // extern "C"
