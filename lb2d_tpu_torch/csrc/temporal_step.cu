// K2: K D2Q9 lattice-Boltzmann steps per pass over f, for Hopper (sm_90a),
// with each physics of lb2d_tpu/ops/fused.py:make_temporal_pipe_step: the
// pressure-driven flow, the velocity inlet (either outlet, an optional
// obstacle) and the periodic diffusion and noisy Fisher. Every physics runs
// the row sweep of temporal_sweep.cuh on the whole periodic grid (that
// header says how, what bounds it and what it measured); K9, the same
// sweep on a shard, is halo_step.cu. On small grids the velocity inlet
// runs the first K2's 32 x 32 tiles instead (velocity_tile_kernel below),
// which the wrapper picks by the grid's cells
// (lb2d_tpu_torch/ops/fused.py: VELOCITY_TILE_MAX_CELLS).

#include "temporal_sweep.cuh"

namespace {

template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t launch(const float* f_in, float* f_out, const int* mask, int ny,
                   int nx, int K, const StepParams& prm, cudaStream_t stream) {
  static SweepSlots cache;  // per instantiation
  return launch_sweep<kObstacle>(
      temporal_step_kernel<kPhys, kIncomp, kObstacle>, cache, ny, nx, K, prm,
      stream, f_in, f_out, mask, ny, nx);
}

template <int kPhys>
cudaError_t dispatch(const float* f_in, float* f_out, const int* mask, int ny,
                     int nx, int K, const StepParams& prm, int incompressible,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible) {
    return mask ? launch<kPhys, true, true>(f_in, f_out, mask, ny, nx, K, prm, s)
                : launch<kPhys, true, false>(f_in, f_out, mask, ny, nx, K, prm, s);
  }
  return mask ? launch<kPhys, false, true>(f_in, f_out, mask, ny, nx, K, prm, s)
              : launch<kPhys, false, false>(f_in, f_out, mask, ny, nx, K, prm, s);
}

// The tile loop of K2's velocity inlet on small grids: a 32 x 32 region of
// cells, halo included, in shared memory, each block writing the inner
// (32 - 2K)^2 cells of its region after K steps with a block barrier
// between them. At the inlet's 401^2 it beats every plan of the row sweep
// tried on an H100 (PERF.md, section 6): 0.0063 and 0.0069 ms per step at
// K = 3 and 4 by graph replay, against the sweep's best 0.0081 and 0.0088
// (strips of 64 columns, segments of 6 rows, a plan since removed; on 128
// columns 0.0096 and 0.0094). A sweep phase takes one level's update of
// two cells a thread and a barrier, about 1.3 us on a lightly loaded SM,
// and a segment needs its rows plus 3K phases in a row; a tile needs K
// rounds of four independent cells a thread.
constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kTile;  // 8
constexpr int kPasses = kTile / kRowsPerPass;   // 4 rows per thread
constexpr int kPlane = kTile * kTile;           // cells per region plane
constexpr int kTileMaxK = 8;                    // inner edge >= 16

template <bool kPair, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kThreads, 3)
velocity_tile_kernel(const float* __restrict__ f_in,
                     float* __restrict__ f_out, const int* __restrict__ mask,
                     int ny, int nx, int K, StepParams prm) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + 9 * kPlane;
  unsigned char* solid = reinterpret_cast<unsigned char*>(smem + 18 * kPlane);

  const int inner = kTile - 2 * K;
  const int y0 = blockIdx.y * inner - K;  // unwrapped row of region row 0
  const int x0 = blockIdx.x * inner - K;
  const int c = threadIdx.x % kTile;
  const int r_first = threadIdx.x / kTile;
  const int gx = wrap(x0 + c, nx);
  const size_t plane = (size_t)ny * nx;

  // the step-0 region
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r_first + i * kRowsPerPass;
    const size_t g = (size_t)wrap(y0 + r, ny) * nx + gx;
#pragma unroll
    for (int j = 0; j < 9; ++j) cur[j * kPlane + r * kTile + c] = f_in[j * plane + g];
    if (kObstacle) solid[r * kTile + c] = mask[g] != 0;
  }
  __syncthreads();

  for (int s = 1; s <= K; ++s) {
    const bool last = s == K;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r_first + i * kRowsPerPass;
      if (r < s || r >= kTile - s || c < s || c >= kTile - s) continue;
      if (last && (y0 + r >= ny || x0 + c >= nx)) continue;  // ragged edge
      const int gy = wrap(y0 + r, ny);
      const float* p = cur + r * kTile + c;
      float v[9], out[9];
      v[0] = p[0 * kPlane];
      v[1] = p[1 * kPlane - 1];
      v[2] = p[2 * kPlane - kTile];
      v[3] = p[3 * kPlane + 1];
      v[4] = p[4 * kPlane + kTile];
      v[5] = p[5 * kPlane - kTile - 1];
      v[6] = p[6 * kPlane - kTile + 1];
      v[7] = p[7 * kPlane + kTile + 1];
      v[8] = p[8 * kPlane + kTile - 1];
      const bool sol = kObstacle && solid[r * kTile + c];
      float up[3] = {0.0f, 0.0f, 0.0f};
      if (!kPair && gx == nx - 1) {
        up[0] = p[3 * kPlane];
        up[1] = p[6 * kPlane - kTile];
        up[2] = p[7 * kPlane + kTile];
      }
      velocity_cell_update<kPair, kIncomp, kObstacle>(v, up, out, gx, nx, sol,
                                                      prm.omega, prm.a, prm.b);
      if (last) {
        const size_t g = (size_t)gy * nx + gx;
#pragma unroll
        for (int j = 0; j < 9; ++j) f_out[j * plane + g] = out[j];
      } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) nxt[j * kPlane + r * kTile + c] = out[j];
      }
    }
    if (!last) {
      __syncthreads();  // step s complete before step s+1 reads it
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <bool kPair, bool kIncomp, bool kObstacle>
cudaError_t velocity_tile_launch(const float* f_in, float* f_out,
                                 const int* mask, int ny, int nx, int K,
                                 const StepParams& prm, cudaStream_t stream) {
  const int smem = 18 * kPlane * (int)sizeof(float) + (kObstacle ? kPlane : 0);
  // once per instantiation and card: the attribute is the card's
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        velocity_tile_kernel<kPair, kIncomp, kObstacle>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int inner = kTile - 2 * K;
  const dim3 grid((nx + inner - 1) / inner, (ny + inner - 1) / inner);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  velocity_tile_kernel<kPair, kIncomp, kObstacle>
      <<<grid, kThreads, smem, stream>>>(f_in, f_out, mask, ny, nx, K, prm);
  return cudaGetLastError();
}

template <bool kPair>
cudaError_t velocity_tile_dispatch(const float* f_in, float* f_out,
                                   const int* mask, int ny, int nx, int K,
                                   const StepParams& prm, int incompressible,
                                   cudaStream_t s) {
  if (incompressible) {
    return mask ? velocity_tile_launch<kPair, true, true>(f_in, f_out, mask,
                                                          ny, nx, K, prm, s)
                : velocity_tile_launch<kPair, true, false>(f_in, f_out, mask,
                                                           ny, nx, K, prm, s);
  }
  return mask ? velocity_tile_launch<kPair, false, true>(f_in, f_out, mask,
                                                         ny, nx, K, prm, s)
              : velocity_tile_launch<kPair, false, false>(f_in, f_out, mask,
                                                          ny, nx, K, prm, s);
}

}  // namespace

// k_steps pressure-driven steps of f_in into f_out. f_in, f_out: [9, ny, nx]
// float32, contiguous, distinct. mask: [ny, nx] int32 or NULL.
// 1 <= k_steps <= sweep_max_k<1>() (8). Launches on `stream` and returns
// the launch's CUDA error code.
extern "C" int lb2d_temporal_step(const float* f_in, float* f_out,
                                  const int* mask, int ny, int nx, int k_steps,
                                  float omega, float inlet_rho,
                                  float outlet_rho, int incompressible,
                                  void* stream) {
  if (ny < 1 || nx < 1 || k_steps < 1 || k_steps > sweep_max_k<1>())
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, inlet_rho, outlet_rho, 0.0f, 0.0f, 0u, 0u, 0ull};
  return (int)dispatch<kFlow>(f_in, f_out, mask, ny, nx, k_steps, prm,
                              incompressible, stream);
}

// k_steps velocity-inlet steps of f_in into f_out (inlet velocity u_w;
// outlet velocity u_e with velocity_outlet, else the zero-gradient outlet).
// Arguments and result as lb2d_temporal_step; nx >= 2.
extern "C" int lb2d_temporal_velocity_step(const float* f_in, float* f_out,
                                           const int* mask, int ny, int nx,
                                           int k_steps, float omega, float u_w,
                                           float u_e, int velocity_outlet,
                                           int incompressible, void* stream) {
  if (ny < 1 || nx < 2 || k_steps < 1 || k_steps > sweep_max_k<1>())
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u_w, u_e, 0.0f, 0.0f, 0u, 0u, 0ull};
  if (velocity_outlet)
    return (int)dispatch<kVelocityPair>(f_in, f_out, mask, ny, nx, k_steps,
                                        prm, incompressible, stream);
  return (int)dispatch<kVelocityOpen>(f_in, f_out, mask, ny, nx, k_steps, prm,
                                      incompressible, stream);
}

// The same steps as lb2d_temporal_velocity_step in 32 x 32 tiles (the
// small grids' loop); arguments and result as there.
extern "C" int lb2d_temporal_velocity_tiles(const float* f_in, float* f_out,
                                            const int* mask, int ny, int nx,
                                            int k_steps, float omega,
                                            float u_w, float u_e,
                                            int velocity_outlet,
                                            int incompressible, void* stream) {
  if (ny < 1 || nx < 2 || k_steps < 1 || k_steps > kTileMaxK)
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u_w, u_e, 0.0f, 0.0f, 0u, 0u, 0ull};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (velocity_outlet)
    return (int)velocity_tile_dispatch<true>(f_in, f_out, mask, ny, nx,
                                             k_steps, prm, incompressible, s);
  return (int)velocity_tile_dispatch<false>(f_in, f_out, mask, ny, nx,
                                            k_steps, prm, incompressible, s);
}

// k_steps steps of the periodic advection-diffusion family of f_in into
// f_out: imposed lattice velocity (u, v), growth g; with noisy, noise
// amplitude dg, Philox key (key0, key1), global steps step0 .. step0 +
// k_steps - 1, and the clip. Arguments and result as lb2d_temporal_step.
extern "C" int lb2d_temporal_diffusion_step(
    const float* f_in, float* f_out, int ny, int nx, int k_steps, float omega,
    float u, float v, float g, float dg, int noisy, unsigned key0,
    unsigned key1, unsigned long long step0, void* stream) {
  if (ny < 1 || nx < 1 || k_steps < 1 || k_steps > sweep_max_k<1>())
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u, v, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noisy)
    return (int)launch<kNoisyFisher, false, false>(f_in, f_out, nullptr, ny,
                                                   nx, k_steps, prm, s);
  return (int)launch<kDiffusion, false, false>(f_in, f_out, nullptr, ny, nx,
                                               k_steps, prm, s);
}
