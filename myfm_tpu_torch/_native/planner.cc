// Host-side native planner of the port's design compiler.
//
// A copy of the TPU package's planner (myfm_tpu/_native/planner.cc),
// entry points and outputs unchanged.  Three sequential host passes of
// design compilation that numpy cannot vectorise, each O(rows) or
// O(nnz):
//
//   myfm_greedy_color  row-disjoint coloring of CSC columns
//                      (design.greedy_color);
//   myfm_packed_rows   the padded row count of the greedy tile packing
//                      (design_categorical.choose_tiling and the gate);
//   myfm_pack_tiles    the greedy tile packing itself
//                      (design_categorical._pack_tiles).
//
// Built with the host C++ compiler at first use and loaded with ctypes
// (myfm_tpu_torch/_native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy row-disjoint coloring of CSC columns.
//
//   indptr  : [n_cols + 1] int64 column pointers
//   indices : [nnz]        int32 row indices
//   assign  : [n_cols]     int32 output color per column
//
// Invariant (the same as the numpy loop, greedy_color(plain=True)):
// c[r] is the smallest color safe for any future column touching row
// r.  A column's color is max(c[rows]); afterwards c[rows] is raised to
// color + 1, so columns sharing a row always land in different colors.
void myfm_greedy_color(int64_t n_rows, int64_t n_cols,
                       const int64_t* indptr, const int32_t* indices,
                       int32_t* assign) {
  std::vector<int32_t> c(static_cast<size_t>(n_rows), 0);
  for (int64_t f = 0; f < n_cols; ++f) {
    int32_t col = 0;
    const int64_t begin = indptr[f];
    const int64_t end = indptr[f + 1];
    for (int64_t p = begin; p < end; ++p) {
      col = std::max(col, c[indices[p]]);
    }
    assign[f] = col;
    const int32_t next = col + 1;
    for (int64_t p = begin; p < end; ++p) {
      int32_t& cr = c[indices[p]];
      cr = std::max(cr, next);
    }
  }
}

// Exact padded row count of the greedy (T-row, <=S-entity) packing —
// the inner loop of design_categorical.choose_tiling.
int64_t myfm_packed_rows(int64_t n_entities, const int64_t* counts,
                         int64_t T, int64_t S) {
  int64_t total = 0, row_fill = 0, ent_fill = 0;
  for (int64_t u = 0; u < n_entities; ++u) {
    int64_t c = counts[u];
    if (c == 0) continue;
    int64_t taken = 0;
    while (taken < c) {
      if (row_fill >= T || ent_fill >= S) {
        total += T;
        row_fill = 0;
        ent_fill = 0;
      }
      int64_t take = std::min(c - taken, T - row_fill);
      taken += take;
      row_fill += take;
      ent_fill += 1;
    }
  }
  if (row_fill) total += T;
  return total;
}

// Greedy tile packing (design_categorical._pack_tiles).  Caller sizes
// the outputs from myfm_packed_rows(+one trailing pad tile):
//   n_out = packed_rows + T.
// Inputs: order[n] (row indices sorted by entity), counts[n_entities].
// Outputs (lengths): src/slot/ent [n_out]; cont_in/cont_out/last_slot
// [n_out/T]; ent_slots [n_out/T * S]; final_part [n_entities].
// Pads: src = n, ent = n_entities, ent_slots = n_entities,
// final_part(empty entity) = (K-1)*S (first slot of the pad tile).
void myfm_pack_tiles(int64_t n, int64_t n_entities, const int64_t* order,
                     const int64_t* counts, int64_t T, int64_t S,
                     int64_t n_out, int32_t* src, int32_t* slot,
                     int32_t* ent, int32_t* cont_in, int32_t* cont_out,
                     int32_t* last_slot, int32_t* ent_slots,
                     int32_t* final_part) {
  const int64_t K = n_out / T;
  for (int64_t i = 0; i < n_out; ++i) {
    src[i] = static_cast<int32_t>(n);
    slot[i] = 0;
    ent[i] = static_cast<int32_t>(n_entities);
  }
  for (int64_t k = 0; k < K; ++k) {
    cont_in[k] = 0;
    cont_out[k] = 0;
    last_slot[k] = 0;
    for (int64_t s = 0; s < S; ++s)
      ent_slots[k * S + s] = static_cast<int32_t>(n_entities);
  }
  for (int64_t u = 0; u < n_entities; ++u)
    final_part[u] = static_cast<int32_t>((K - 1) * S);

  int64_t pos = 0;       // cursor into `order`
  int64_t tile = 0;      // current tile
  int64_t row_fill = 0;  // rows used in current tile
  int64_t ent_fill = 0;  // slots used in current tile
  int64_t prev_last = -1;  // last entity of the previous tile
  int64_t cur_last = -1;   // last entity of the current tile
  int64_t cur_first = -1;
  for (int64_t u = 0; u < n_entities; ++u) {
    int64_t c = counts[u];
    if (c == 0) continue;
    int64_t taken = 0;
    while (taken < c) {
      if (row_fill >= T || ent_fill >= S) {
        last_slot[tile] = std::max<int64_t>(ent_fill - 1, 0);
        prev_last = cur_last;
        ++tile;
        row_fill = 0;
        ent_fill = 0;
        cur_first = -1;
      }
      int64_t take = std::min(c - taken, T - row_fill);
      const int64_t base = tile * T + row_fill;
      for (int64_t j = 0; j < take; ++j) {
        src[base + j] = static_cast<int32_t>(order[pos + j]);
        slot[base + j] = static_cast<int32_t>(ent_fill);
        ent[base + j] = static_cast<int32_t>(u);
      }
      if (cur_first < 0) {
        cur_first = u;
        if (u == prev_last) {
          cont_in[tile] = 1;
          cont_out[tile - 1] = 1;
        }
      }
      cur_last = u;
      ent_slots[tile * S + ent_fill] = static_cast<int32_t>(u);
      final_part[u] = static_cast<int32_t>(tile * S + ent_fill);
      pos += take;
      taken += take;
      row_fill += take;
      ent_fill += 1;
    }
  }
  if (row_fill) {
    last_slot[tile] = std::max<int64_t>(ent_fill - 1, 0);
  }
}

}  // extern "C"
