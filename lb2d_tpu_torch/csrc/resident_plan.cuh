// The plan of the one-launch run K3 (resident_run.cu): the cut of the grid
// into bands, the shared memory of a block, the halo planes of an edge and
// the layout of the exchange buffers. lb2d_tpu_torch/ops/resident_plan.py
// mirrors every function here under the same name; the wrappers choose the
// layout, the bands and the cluster size there and the kernel recomputes the
// rest.
//
// Every function works in the ring's frame: `rows` ring rows of `len` cells
// each. With bands of rows a ring row is a grid row (rows = ny, len = nx);
// with strips of columns, for rows too wide for a block, it is a grid column
// (rows = nx, len = ny) and ring plane q holds direction transpose_dir(q).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kResThreads = 512;        // one block per SM
constexpr int kResCellsPerThread = 4;   // cells a thread holds per group
constexpr int kResMaxCluster = 16;      // non-portable above 8
constexpr int kResFlagWords = 32;       // a 128-byte line per band's flag
constexpr int kResSlots = 2;            // exchange buffers per edge
constexpr int kResHaloPlanes = 3;       // planes of an edge's row

// The direction of D2Q9 whose (cx, cy) is direction q's (cy, cx): with
// strips of columns the ring holds the transposed grid, and ring plane q
// holds this direction, so that the ring's pulls are the bands' pulls. An
// involution: 1 <-> 2, 3 <-> 4, 6 <-> 8.
__host__ __device__ inline int transpose_dir(int q) {
  switch (q) {
    case 1: return 2;
    case 2: return 1;
    case 3: return 4;
    case 4: return 3;
    case 6: return 8;
    case 8: return 6;
    default: return q;
  }
}

// The first ring row of band b (an even cut; band `bands` starts at rows).
__host__ __device__ inline int band_first_row(int b, int rows, int bands) {
  return (int)(((long long)b * rows) / bands);
}

__host__ __device__ inline int rows_max(int rows, int bands) {
  return (rows + bands - 1) / bands;
}

// Whole ring rows of a group: as many as the block's threads hold.
__host__ __device__ inline int group_rows(int len) {
  return kResCellsPerThread * kResThreads / len;
}

// The ring of rows_max + 2 rows of 9 planes and, in a cluster or a grid of
// one band, the inbox: kResSlots x 2 edges x kResHaloPlanes planes.
__host__ inline size_t smem_bytes(int rows, int len, int bands, int cluster) {
  const size_t ring = 9 * (size_t)(rows_max(rows, bands) + 2);
  const size_t inbox = (cluster > 1 || bands == 1)
                           ? (size_t)kResSlots * 2 * kResHaloPlanes : 0;
  return 4 * (size_t)len * (ring + inbox);
}

// Floats of scratch that the exchange between clusters uses: the flags,
// then kResSlots x bands x 2 edges x kResHaloPlanes planes of a ring row.
__host__ inline size_t exchange_floats(int bands, int len) {
  return (size_t)kResFlagWords * bands
         + (size_t)kResSlots * bands * 2 * kResHaloPlanes * len;
}

// Edge `edge` of `band` in `slot`, in floats from the start of scratch
// (edge 0: its first row, for the band before; 1: its last row).
__host__ __device__ inline size_t gbuf_offset(int slot, int band, int edge,
                                              int bands, int len) {
  return (size_t)kResFlagWords * bands
         + ((size_t)(slot * bands + band) * 2 + edge) * kResHaloPlanes * len;
}

// An edge in a block's inbox, in floats from the inbox's start (edge 0:
// from the band after, 1: from the band before).
__host__ __device__ inline int inbox_offset(int slot, int edge, int len) {
  return (slot * 2 + edge) * kResHaloPlanes * len;
}

// Whether `band` and its neighbour exchange edges through the receiver's
// inbox (one cluster, or a grid of one band) rather than through scratch.
__host__ __device__ inline bool local_edge(int band, int neighbour, int bands,
                                           int cluster) {
  return bands == 1 || (cluster > 1 && neighbour / cluster == band / cluster);
}

// Ring plane p of an edge: edge 0 (the sender's first row, the receiver's
// row R) carries 4, 7, 8 (cy = -1, pulled from the row after), edge 1 (the
// sender's last row, the receiver's row -1) 2, 5, 6 (cy = +1).
__host__ __device__ inline int edge_plane(int edge, int p) {
  if (edge == 0) return p == 0 ? 4 : p == 1 ? 7 : 8;
  return p == 0 ? 2 : p == 1 ? 5 : 6;
}

// The inverse of edge_plane: the plane of ring plane j on an edge, or -1
// where the edge does not carry it.
__host__ __device__ inline int plane_of(int edge, int j) {
  if (edge == 0) return j == 4 ? 0 : j == 7 ? 1 : j == 8 ? 2 : -1;
  return j == 2 ? 0 : j == 5 ? 1 : j == 6 ? 2 : -1;
}

}  // namespace
