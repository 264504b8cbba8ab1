// n D2Q9 lattice-Boltzmann steps in one launch, for Hopper (sm_90a): K3.
//
// Replaces lb2d_tpu/ops/fused.py:make_resident_pipe_step with each of its
// physics: "flow", "velocity_inlet" (here with either outlet and an
// optional obstacle, as K2's velocity variant) and the periodic
// "diffusion" and "noisy_fisher". On the TPU the whole state sits in VMEM
// and one kernel loops over the n steps, so a small grid pays no dispatch
// per step. Here the state sits in the shared memory of persistent blocks
// for the whole launch, and a block waits only for the two blocks whose
// rows it pulls from, not for the whole grid.
//
// Design (the plan: resident_plan.cuh, mirrored by ops/resident_plan.py):
// block b owns a band of whole rows [y0, y0 + R) and reads it from f once
// at the start and writes it back once at the end; no population of an
// owned cell goes to global memory in between. The band lives in a ring of
// R + 2 rows of 9 planes in shared memory: its rows and one halo row on
// each side. A step computes a group of whole rows into registers (at most
// kResCellsPerThread cells a thread), waits at a block barrier, and writes
// each new row r into the ring slot of the old row r - 1, which no later
// group reads (the next group's first row pulls the old row above it, still
// in its own slot); then the ring's offset moves back by one, so the ring
// needs no second copy of the band. After every step a block publishes its
// first and last rows, only the directions its neighbours pull across the
// edge (4, 7, 8 of the first row for the band above, 2, 5, 6 of the last
// for the band below), as the step's write phase stores them, and then
// waits for its two neighbours alone (two steps between exchanges, with a
// recomputed halo row as K2 does it, measured slower on three of the four
// physics; PERF.md):
//   - inside a thread-block cluster (a grid of at most 16 bands, 32x256
//     among them, is one; larger grids measured faster with none) into the
//     receiver's inbox in shared memory, stored through distributed shared
//     memory as the sender writes its rows, with the cluster barrier as the
//     signal: the receiver reads only its own shared memory (remote loads,
//     pulling from the sender, cost 1.7x the loads from L2);
//   - between clusters (or blocks, with clusters of 1) through scratch: the
//     edges, then, after the block barrier that ends the step, a flag per
//     band written by one thread with st.release.gpu; the receiver's
//     thread polls its neighbours' flags with ld.acquire.gpu, a block
//     barrier follows, and the block reads the edges through L2 (__ldcg).
//     (A full fence on each side, __threadfence, cost 0.7 us a step.)
// The exchange loops run over planes known at compile time and the row's
// columns, with no division per element.
// Both buffers have two slots, by the parity of the exchange: a block
// writes exchange e + 2 into the slot of exchange e only after it has
// waited for its neighbours' exchange e + 1, which each of them publishes
// only after it has read exchange e (the CPU emulation,
// tests/test_torch_resident_plan.py, runs a schedule where one slot fails).
// The edges also carry the zero-gradient outlet's pre-stream f6[y-1, nx-1]
// and f7[y+1, nx-1]. Rows wrap periodically (the first and last bands are
// neighbours; a grid of one band is its own) and every cell applies its
// BCs by its global row and draws its noise by its global index, so a run
// is the same trajectory as n plain steps, noise included: the Philox
// normal of (cell, step0 + i) at in-launch step i (philox.cuh).
//
// Strips: a grid whose rows are too wide for a block's threads, or whose
// bands do not fit shared memory, is cut into strips of whole columns
// (16x4096, for one). The kernel's kStrip instantiations run the same code
// on the transposed grid: a ring row is a column of ny cells and ring plane
// q holds direction transpose_dir(q), so that the pulls, the edges and
// their planes are the bands' own; each cell swaps its 9 values into the
// update's order and back, and applies its BCs, mask and noise by its true
// row and column.
//
// Residency: blocks that wait on each other's flags must all run at once,
// so a launch with exchanges through scratch is cooperative
// (cudaLaunchAttributeCooperative), and its blocks per SM come from the
// occupancy query at this launch's shared memory (max active clusters for
// a cluster launch); a launch that cannot be made returns an error.
//
// Bound: the time of a step is latency: one cell's update per thread (a
// flow step's compute takes 4,000-4,800 cycles at one cell a thread on an
// H100, tools/profile_k3.py), the block barriers and the exchange's wait,
// against a host launch of more than ten microseconds per step for K1.
// The bytes are f read and written once per launch.

#include <cooperative_groups.h>

#include "pipe_cell.cuh"
#include "resident_plan.cuh"

namespace cg = cooperative_groups;

namespace {

// physics, a template parameter of the kernel (as in temporal_step.cu)
constexpr int kFlow = 0;
constexpr int kVelocityOpen = 1;
constexpr int kVelocityPair = 2;
constexpr int kDiffusion = 3;
constexpr int kNoisyFisher = 4;

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Wait until both neighbours' flags reach `target` (a null flag is not
// waited for), polling the two together. A neighbour that never publishes
// (a block that is not resident) ends the launch with an error after 20 s
// instead of holding the card.
__device__ __forceinline__ void wait_flags(const unsigned* a,
                                           const unsigned* b,
                                           unsigned target) {
  unsigned long long start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  while (true) {
    const unsigned va = a ? ld_acquire_gpu(a) : target;
    const unsigned vb = b ? ld_acquire_gpu(b) : target;
    if (va >= target && vb >= target) return;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - start > 20000000000ull) __trap();
  }
}

// The ring slot of band row r (-1 <= r <= R) at offset `off`.
__device__ __forceinline__ int ring_slot(int r, int off, int S) {
  int v = r + off;
  if (v < 0) v += S;
  if (v >= S) v -= S;
  return v;
}

// Swap a cell's 9 values between the ring's planes and the directions of
// the transposed grid (transpose_dir), in place.
__device__ __forceinline__ void transpose_values(float* v) {
  float t = v[1];
  v[1] = v[2];
  v[2] = t;
  t = v[3];
  v[3] = v[4];
  v[4] = t;
  t = v[6];
  v[6] = v[8];
  v[8] = t;
}

// Element i (0 <= i < 9 R len) of a band of R ring rows of len cells from
// ring row y0, the ring at offset `off`: where it sits in the ring and in
// f (planes of `plane` floats, rows of nx); consecutive i along a row of
// f. Plain values, not a lambda's captures: captured by reference, the
// band's geometry went to the stack and the kernel spilled.
template <bool kStrip>
__device__ __forceinline__ void band_element(int i, int R, int len, int off,
                                             int nx, int y0, size_t plane,
                                             int& at_ring, size_t& at_f) {
  const int S = R + 2;
  const int j = i / (R * len);
  const int rem = i - j * R * len;
  if constexpr (!kStrip) {
    const int r = rem / len;
    at_ring = (ring_slot(r, off, S) * 9 + j) * len + (rem - r * len);
    at_f = j * plane + (size_t)y0 * nx + rem;
  } else {
    const int v = rem / R;
    const int r = rem - v * R;
    at_ring = (ring_slot(r, off, S) * 9 + transpose_dir(j)) * len + v;
    at_f = j * plane + (size_t)v * nx + y0 + r;
  }
}

template <int kPhys, bool kIncomp, bool kObstacle, bool kStrip>
__global__ void __launch_bounds__(kResThreads, 1)
resident_band_kernel(float* __restrict__ f, float* scratch,
                     const int* __restrict__ mask, int ny, int nx, int n,
                     int bands, int cluster_size, StepParams prm) {
  extern __shared__ float ring[];
  constexpr int P = kResHaloPlanes;
  constexpr int C = kResCellsPerThread;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int rows = kStrip ? nx : ny;  // the ring's frame: rows of len cells
  const int len = kStrip ? ny : nx;
  const int y0 = band_first_row(b, rows, bands);
  const int R = band_first_row(b + 1, rows, bands) - y0;
  const int S = R + 2;
  const size_t plane = (size_t)ny * nx;
  const int rowf = 9 * len;  // floats of one ring row
  float* inbox = ring + (rows_max(rows, bands) + 2) * rowf;
  const int up = b == 0 ? bands - 1 : b - 1;
  const int down = b == bands - 1 ? 0 : b + 1;
  const bool clustered = cluster_size > 1;
  const bool up_local = local_edge(b, up, bands, cluster_size);
  const bool down_local = local_edge(b, down, bands, cluster_size);
  const bool any_global = !up_local || !down_local;
  unsigned* flags = reinterpret_cast<unsigned*>(scratch);
  const int G = group_rows(len);
  // where exchange e's edges go: edge 0 (the first row) for the band above,
  // 1 (the last row) for the band below; inside a cluster into the
  // receiver's inbox, through distributed shared memory
  auto edge_out = [&](int e, int edge) {
    const bool local = edge == 0 ? up_local : down_local;
    if (!local) return scratch + gbuf_offset(e & 1, b, edge, bands, len);
    float* box = inbox + inbox_offset(e & 1, edge, len);
    if (!clustered) return box;  // a grid of one band: its own inbox
    return cg::this_cluster().map_shared_rank(
        box, (unsigned)((edge == 0 ? up : down) % cluster_size));
  };
  int off = 1;  // band row r sits in ring slot (r + off) mod S

  // each thread's cells of a group: ring row gr[c] of the group, cell gx[c]
  int gr[C], gx[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = tid + c * kResThreads;
    gr[c] = i / len;
    gx[c] = i - gr[c] * len;
  }
  float coef[9];  // the diffusion family's (1 + c.u / cs2)
  feq_coefficients(prm.a, prm.b, coef);

  for (int i = tid; i < 9 * R * len; i += kResThreads) {
    int at_ring;
    size_t at_f;
    band_element<kStrip>(i, R, len, off, nx, y0, plane, at_ring, at_f);
    ring[at_ring] = f[at_f];
  }
  // the cluster's blocks have started before any writes into their inboxes
  if (clustered) cg::this_cluster().sync();
  __syncthreads();
  {  // exchange 0's edges, from the band as loaded (later ones go out as
     // each step writes its rows)
    float* to_up = edge_out(0, 0);
    float* to_down = edge_out(0, 1);
    const float* first = ring + ring_slot(0, off, S) * rowf;
    const float* last = ring + ring_slot(R - 1, off, S) * rowf;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* top = first + edge_plane(0, p) * len;
      const float* bot = last + edge_plane(1, p) * len;
      for (int i = tid; i < 2 * len; i += kResThreads) {
        if (i < len) to_up[p * len + i] = top[i];
        else to_down[p * len + i - len] = bot[i - len];
      }
    }
  }
  __syncthreads();

  for (int e = 0; e < n; ++e) {
    const int slot = e & 1;
    // signal exchange e and wait for the two neighbours': release at gpu
    // scope by one thread, after the block barrier that ended the step, and
    // acquire; or the cluster barrier
    if (any_global && tid == 0)
      st_release_gpu(flags + (size_t)b * kResFlagWords, (unsigned)e + 1);
    if (clustered) cg::this_cluster().sync();
    if (any_global) {
      if (tid == 0)
        wait_flags(up_local ? nullptr : flags + (size_t)up * kResFlagWords,
                   down_local ? nullptr : flags + (size_t)down * kResFlagWords,
                   (unsigned)e + 1);
      __syncthreads();
    }
    // fetch: the band above's edge 1 into row -1, the band below's edge 0
    // into row R, from this block's inbox or scratch
    const float* from_up =
        up_local ? inbox + inbox_offset(slot, 1, len)
                 : scratch + gbuf_offset(slot, up, 1, bands, len);
    const float* from_down =
        down_local ? inbox + inbox_offset(slot, 0, len)
                   : scratch + gbuf_offset(slot, down, 0, bands, len);
    // a thread takes one cell of one edge: every plane's load first, so
    // that the loads are in flight together, then the stores
    for (int i = tid; i < 2 * len; i += kResThreads) {
      const int edge = i < len ? 1 : 0;  // edge 1 of the band above, 0 below
      const int x = edge ? i : i - len;
      const bool local = edge ? up_local : down_local;
      const float* src = (edge ? from_up : from_down) + x;
      float v[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[p] = local ? src[p * len] : __ldcg(src + p * len);
      float* dst = ring + ring_slot(edge ? -1 : R, off, S) * rowf + x;
#pragma unroll
      for (int p = 0; p < P; ++p) dst[edge_plane(edge, p) * len] = v[p];
    }
    __syncthreads();

    // the step: rows 0 .. R - 1, group by group; where an exchange follows,
    // the write phase also sends the first and last rows' edges
    const bool publish = e + 1 < n;
    float* to_up = edge_out(e + 1, 0);
    float* to_down = edge_out(e + 1, 1);
    const unsigned long long step = prm.step0 + (unsigned long long)e;
    for (int g0 = 0; g0 < R; g0 += G) {
      const int group = min(G, R - g0);
      float out[C][9];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (gr[c] >= group) continue;
        const int r = g0 + gr[c];
        const int v = gx[c];
        const float* rm = ring + ring_slot(r - 1, off, S) * rowf;
        const float* r0 = ring + ring_slot(r, off, S) * rowf;
        const float* rp = ring + ring_slot(r + 1, off, S) * rowf;
        const int vm = v == 0 ? len - 1 : v - 1;  // source cell, cx = +1
        const int vp = v == len - 1 ? 0 : v + 1;  // source cell, cx = -1
        // s_j = f[j, y - cy_j, x - cx_j], the numbering of pipe_cell.cuh,
        // in the ring's frame
        float s[9] = {r0[v],            r0[len + vm],     rm[2 * len + v],
                      r0[3 * len + vp], rp[4 * len + v],  rm[5 * len + vm],
                      rm[6 * len + vp], rp[7 * len + vp], rp[8 * len + vm]};
        if constexpr (kStrip) transpose_values(s);
        const int gy = kStrip ? v : y0 + r;  // the cell's row and column
        const int x = kStrip ? y0 + r : v;
        const bool solid = kObstacle && __ldg(mask + (size_t)gy * nx + x) != 0;
        if constexpr (kPhys == kFlow) {
          cell_update<kIncomp, kObstacle>(s, out[c], gy, x, ny, nx, solid,
                                          prm.omega, prm.a, prm.b);
        } else if constexpr (kPhys == kDiffusion || kPhys == kNoisyFisher) {
          diffusion_cell_update<kPhys == kNoisyFisher>(
              s, out[c], prm, (unsigned long long)gy * nx + x, step, coef);
        } else {
          // the zero-gradient outlet takes the pre-stream f[3, y, nx-1],
          // f[6, y-1, nx-1], f[7, y+1, nx-1] (pipe_cell.cuh): in a strip,
          // ring planes 4, 8, 7 of the cell's own column
          float upv[3] = {0.0f, 0.0f, 0.0f};
          if (kPhys == kVelocityOpen && x == nx - 1) {
            if constexpr (!kStrip) {
              upv[0] = r0[3 * len + v];
              upv[1] = rm[6 * len + v];
              upv[2] = rp[7 * len + v];
            } else {
              upv[0] = r0[4 * len + v];
              upv[1] = r0[8 * len + vm];
              upv[2] = r0[7 * len + vp];
            }
          }
          velocity_cell_update<kPhys == kVelocityPair, kIncomp, kObstacle>(
              s, upv, out[c], x, nx, solid, prm.omega, prm.a, prm.b);
        }
        if constexpr (kStrip) transpose_values(out[c]);
      }
      __syncthreads();  // every cell of the group has pulled
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (gr[c] >= group) continue;
        const int r = g0 + gr[c];
        const int v = gx[c];
        float* dst = ring + ring_slot(r - 1, off, S) * rowf + v;
#pragma unroll
        for (int j = 0; j < 9; ++j) dst[j * len] = out[c][j];
        if (publish && r == 0) {  // edge 0
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const int p = plane_of(0, j);
            if (p >= 0) to_up[p * len + v] = out[c][j];
          }
        }
        if (publish && r == R - 1) {  // edge 1
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const int p = plane_of(1, j);
            if (p >= 0) to_down[p * len + v] = out[c][j];
          }
        }
      }
      __syncthreads();
    }
    off = off == 0 ? S - 1 : off - 1;
  }

  for (int i = tid; i < 9 * R * len; i += kResThreads) {
    int at_ring;
    size_t at_f;
    band_element<kStrip>(i, R, len, off, nx, y0, plane, at_ring, at_f);
    f[at_f] = ring[at_ring];
  }
  // no block leaves while a neighbour may still write into its inbox
  if (clustered) cg::this_cluster().sync();
}

template <int kPhys, bool kIncomp, bool kObstacle, bool kStrip>
cudaError_t launch(float* f, float* scratch, long long scratch_floats,
                   const int* mask, int ny, int nx, int n, int bands,
                   int cluster, const StepParams& prm, cudaStream_t stream) {
  auto kernel = resident_band_kernel<kPhys, kIncomp, kObstacle, kStrip>;
  const int rows = kStrip ? nx : ny;
  const int len = kStrip ? ny : nx;
  const size_t smem = smem_bytes(rows, len, bands, cluster);
  const bool global = bands > cluster;  // some edge goes through scratch
  if (global && (size_t)scratch_floats < exchange_floats(bands, len))
    return cudaErrorInvalidValue;
  int device, optin, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  int count = 0;
  if (cluster > 1) {
    attrs[count].id = cudaLaunchAttributeClusterDimension;
    attrs[count].val.clusterDim.x = cluster;
    attrs[count].val.clusterDim.y = 1;
    attrs[count].val.clusterDim.z = 1;
    ++count;
  }
  // residency at this launch's shared memory: every block at once
  cfg.attrs = attrs;
  cfg.numAttrs = count;
  if (cluster > 1) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active < bands / cluster) return cudaErrorCooperativeLaunchTooLarge;
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kResThreads, smem);
    if (err != cudaSuccess) return err;
    if ((long long)per_sm * sms < bands)
      return cudaErrorCooperativeLaunchTooLarge;
  }
  if (global) {  // blocks wait on each other's flags
    attrs[count].id = cudaLaunchAttributeCooperative;
    attrs[count].val.cooperative = 1;
    ++count;
    cfg.numAttrs = count;
    err = cudaMemsetAsync(scratch, 0,
                          (size_t)bands * kResFlagWords * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, f, scratch, mask, ny, nx, n, bands,
                           cluster, prm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's checks; the kernel takes any plan that passes them.
bool valid_plan(int ny, int nx, int n, int strip, int bands, int cluster) {
  const int rows = strip ? nx : ny;
  const int len = strip ? ny : nx;
  return ny >= 1 && nx >= 1 && n >= 1 && (strip == 0 || strip == 1)
         && bands >= 1 && bands <= rows && cluster >= 1
         && cluster <= kResMaxCluster && bands % cluster == 0
         && len <= kResCellsPerThread * kResThreads;
}

// The layout, a template parameter: the bands' code compiles as if strips
// did not exist (a runtime flag cost 5% on the diffusion family in spills).
template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t by_layout(float* f, float* scratch, long long scratch_floats,
                      const int* mask, int ny, int nx, int n, int strip,
                      int bands, int cluster, const StepParams& prm,
                      cudaStream_t s) {
  if (strip)
    return launch<kPhys, kIncomp, kObstacle, true>(
        f, scratch, scratch_floats, mask, ny, nx, n, bands, cluster, prm, s);
  return launch<kPhys, kIncomp, kObstacle, false>(
      f, scratch, scratch_floats, mask, ny, nx, n, bands, cluster, prm, s);
}

template <int kPhys>
cudaError_t dispatch(float* f, float* scratch, long long scratch_floats,
                     const int* mask, int ny, int nx, int n, int strip,
                     int bands, int cluster, const StepParams& prm,
                     int incompressible, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible) {
    return mask ? by_layout<kPhys, true, true>(f, scratch, scratch_floats,
                                               mask, ny, nx, n, strip, bands,
                                               cluster, prm, s)
                : by_layout<kPhys, true, false>(f, scratch, scratch_floats,
                                                mask, ny, nx, n, strip, bands,
                                                cluster, prm, s);
  }
  return mask ? by_layout<kPhys, false, true>(f, scratch, scratch_floats,
                                              mask, ny, nx, n, strip, bands,
                                              cluster, prm, s)
              : by_layout<kPhys, false, false>(f, scratch, scratch_floats,
                                               mask, ny, nx, n, strip, bands,
                                               cluster, prm, s);
}

}  // namespace

// n pressure-driven steps of f in place, in one launch. f: [9, ny, nx]
// float32, contiguous; scratch: scratch_floats floats, the exchange
// between clusters (its contents are overwritten). mask: [ny, nx] int32 or
// NULL. The plan (ops/resident_plan.py): bands of rows, or with strip
// strips of columns, `bands` blocks in clusters of `cluster`. n >= 1.
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_resident_run(float* f, float* scratch,
                                 long long scratch_floats, const int* mask,
                                 int ny, int nx, int n, int strip, int bands,
                                 int cluster, float omega, float inlet_rho,
                                 float outlet_rho, int incompressible,
                                 void* stream) {
  if (!valid_plan(ny, nx, n, strip, bands, cluster))
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, inlet_rho, outlet_rho, 0.0f, 0.0f, 0u, 0u, 0ull};
  return (int)dispatch<kFlow>(f, scratch, scratch_floats, mask, ny, nx, n,
                              strip, bands, cluster, prm, incompressible,
                              stream);
}

// n velocity-inlet steps of f in place, in one launch (inlet velocity u_w;
// outlet velocity u_e with velocity_outlet, else the zero-gradient outlet;
// periodic in y). Arguments and result as lb2d_resident_run; nx >= 2.
extern "C" int lb2d_resident_velocity_run(
    float* f, float* scratch, long long scratch_floats, const int* mask,
    int ny, int nx, int n, int strip, int bands, int cluster, float omega,
    float u_w, float u_e, int velocity_outlet, int incompressible,
    void* stream) {
  if (nx < 2 || !valid_plan(ny, nx, n, strip, bands, cluster))
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u_w, u_e, 0.0f, 0.0f, 0u, 0u, 0ull};
  if (velocity_outlet)
    return (int)dispatch<kVelocityPair>(f, scratch, scratch_floats, mask, ny,
                                        nx, n, strip, bands, cluster, prm,
                                        incompressible, stream);
  return (int)dispatch<kVelocityOpen>(f, scratch, scratch_floats, mask, ny,
                                      nx, n, strip, bands, cluster, prm,
                                      incompressible, stream);
}

// n steps of the periodic advection-diffusion family of f in place, in one
// launch: imposed lattice velocity (u, v), growth g; with noisy, noise
// amplitude dg, Philox key (key0, key1), global steps step0 .. step0 + n -
// 1, and the clip. Arguments and result as lb2d_resident_run.
extern "C" int lb2d_resident_diffusion_run(
    float* f, float* scratch, long long scratch_floats, int ny, int nx, int n,
    int strip, int bands, int cluster, float omega, float u, float v, float g,
    float dg, int noisy, unsigned key0, unsigned key1,
    unsigned long long step0, void* stream) {
  if (!valid_plan(ny, nx, n, strip, bands, cluster))
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u, v, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noisy)
    return (int)by_layout<kNoisyFisher, false, false>(
        f, scratch, scratch_floats, nullptr, ny, nx, n, strip, bands, cluster,
        prm, s);
  return (int)by_layout<kDiffusion, false, false>(f, scratch, scratch_floats,
                                                  nullptr, ny, nx, n, strip,
                                                  bands, cluster, prm, s);
}
