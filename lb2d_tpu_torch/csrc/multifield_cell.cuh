// The per-cell updates of the multifield range expansions, shared by K4,
// K5 and K9's multifield physics (multifield_step.cu). F, the number of
// fields, is a template parameter. A cell reads field p's 9 pulled values
// through `pull(p, s)` and writes direction j of field p through
// `put(j, p, value)` (row_sweep.cuh: RingPull, RingPut, GlobalPut); the
// state's planes are j * F + p (direction j of field p), the layout of
// f[9][F][ny][nx] and of the TPU kernel's f[9F][ny][nx]
// (lb2d_tpu/ops/fused.py:1561).
//
// fisher_cell_update is the FisherExpansion step of JAX _mf_fisher_tile
// (fused.py:1493-1526) in the order of its plain XLA step
// (lb2d_tpu/models/multifield.py:233-248): no-flux walls and corners by
// the cell's global coordinates (_mf_noflux_walls, fused.py:1442-1490, in
// the same order), rho per field, rho_tot, linear feq, BGK per field and
// + w G_p rho_p (1 - rho_tot). expansion_cell_update is the Expansion step
// of _mf_expansion_tile (fused.py:1380-1439), in the order of
// multifield.py:421-465: rho per field zeroed below the cutoff or NaN,
// growth G_p rho_p c, Milstein noise, nutrient consumption, BGK and the
// clips.
//
// Numerics: every operation rounds on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn are never contracted into FMAs) in the order of
// the plain PyTorch steps in lb2d_tpu_torch/ops/fused.py, and rho is
// summed in direction order, so both updates equal the plain steps bit for
// bit, noise included. The clips need that: an ulp of rho next to the
// cutoff is a jump of the cutoff's size.
//
// Registers: a cell keeps rho and the reaction of each field (2F floats)
// and pulls one field's 9 values at a time, twice (once for the
// densities, once for the collision), so registers do not grow with 9F.

#pragma once

#include <cuda_runtime.h>

#include "philox.cuh"
#include "pipe_cell.cuh"

constexpr int kMaxFields = 8;

// The constants of one K4 or K5 launch, passed by value (ctypes mirror:
// lb2d_tpu_torch/ops/_build.py:MultifieldParams). omega per field (for
// Expansion the populations', then the nutrient's); g, dg per population;
// k0, k1 the Philox key; step0 the global step of the launch's first step.
struct Lb2dMultifieldParams {
  float omega[kMaxFields];
  float g[kMaxFields];
  float dg[kMaxFields];
  float cutoff, u, v;
  unsigned k0, k1;
  unsigned long long step0;
};

namespace {

// No-flux walls and corners of cell (y, x) of an ny x nx grid, from its
// pulled values s into st: the selects of _mf_noflux_walls in its order
// (full bounce-back of the three populations leaving through each wall,
// three per corner). On grids of 3 x 3 and more the masks are disjoint.
__device__ __forceinline__ void noflux_walls(const float (&s)[9],
                                             float (&st)[9], int y, int x,
                                             int ny, int nx) {
#pragma unroll
  for (int j = 0; j < 9; ++j) st[j] = s[j];
  const bool row0 = y == 0, rowN = y == ny - 1;
  const bool lane0 = x == 0, laneN = x == nx - 1;
  if (!(row0 || rowN || lane0 || laneN)) return;
  const bool row_int = y >= 1 && y <= ny - 2;
  const bool lane_int = x >= 1 && x <= nx - 2;
  if (rowN && lane_int) { st[7] = s[5]; st[4] = s[2]; st[8] = s[6]; }
  if (row0 && lane_int) { st[2] = s[4]; st[5] = s[7]; st[6] = s[8]; }
  if (laneN && row_int) { st[3] = s[1]; st[6] = s[8]; st[7] = s[5]; }
  if (lane0 && row_int) { st[1] = s[3]; st[5] = s[7]; st[8] = s[6]; }
  const bool ul = rowN && lane0, ur = rowN && laneN;
  const bool br = row0 && laneN, bl = row0 && lane0;
  if (ul || bl) st[1] = s[3];
  if (ul || ur) st[4] = s[2];
  if (ul) st[8] = s[6];
  if (ur || br) st[3] = s[1];
  if (ur) st[7] = s[5];
  if (br || bl) st[2] = s[4];
  if (br) st[6] = s[8];
  if (bl) st[5] = s[7];
}

__device__ __forceinline__ float sum_in_order(const float (&st)[9]) {
  float r = st[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) r = __fadd_rn(r, st[j]);
  return r;
}

// One FisherExpansion step of the cell whose pulls `pull` reads (global
// coordinates (y, x) of an ny x nx grid); writes through `put`.
template <int F, class Pull, class Put>
__device__ __forceinline__ void fisher_cell_update(
    const Pull& pull, const Put& put, int y, int x, int ny, int nx,
    const Lb2dMultifieldParams& prm, const float (&coef)[9]) {
  const float w[9] = {kW0, kW1, kW1, kW1, kW1, kW2, kW2, kW2, kW2};
  float rho[F];
  float rho_tot = 0.0f;
#pragma unroll
  for (int p = 0; p < F; ++p) {
    float s[9], st[9];
    pull(p, s);
    noflux_walls(s, st, y, x, ny, nx);
    rho[p] = sum_in_order(st);
    rho_tot = p ? __fadd_rn(rho_tot, rho[p]) : rho[p];
  }
  const float one_minus = __fsub_rn(1.0f, rho_tot);
#pragma unroll
  for (int p = 0; p < F; ++p) {
    float s[9], st[9];
    pull(p, s);
    noflux_walls(s, st, y, x, ny, nx);
    const float om = prm.omega[p];
    const float A = __fsub_rn(1.0f, om);
    const float growth = __fmul_rn(__fmul_rn(prm.g[p], rho[p]), one_minus);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float feq = __fmul_rn(__fmul_rn(w[j], rho[p]), coef[j]);
      put(j, p, __fadd_rn(__fadd_rn(__fmul_rn(st[j], A), __fmul_rn(om, feq)),
                          __fmul_rn(w[j], growth)));
    }
  }
}

// One Expansion step (F - 1 populations, the nutrient last) of the cell
// whose pulls `pull` reads and whose noise is that of global cell index
// `cell` at global step `step`: population p draws the normal of Philox
// words 2 (p % 2) and 2 (p % 2) + 1 of counter (cell, step, p >> 1), one call per pair
// (lb2d_tpu_torch/ops/random.py:population_normals_reference); a
// population with dg = 0 draws nothing. Writes as fisher_cell_update.
template <int F, class Pull, class Put>
__device__ __forceinline__ void expansion_cell_update(
    const Pull& pull, const Put& put, unsigned long long cell,
    unsigned long long step, const Lb2dMultifieldParams& prm,
    const float (&coef)[9]) {
  constexpr int P = F - 1;
  const float w[9] = {kW0, kW1, kW1, kW1, kW1, kW2, kW2, kW2, kW2};
  float rho[F];
#pragma unroll
  for (int p = 0; p < F; ++p) {
    float s[9];
    pull(p, s);
    const float r = sum_in_order(s);
    rho[p] = r >= prm.cutoff ? r : 0.0f;  // NaN lands in the zero branch
  }
  const float c = rho[P];
  float react[F];
  float consumed = 0.0f;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float r = __fmul_rn(__fmul_rn(prm.g[p], rho[p]), c);
    if (prm.dg[p] != 0.0f) {
      if ((p & 1) == 0 || prm.dg[p ^ 1] == 0.0f) {
        bits = philox4x32_10(make_uint4((unsigned)cell, (unsigned)step,
                                        (unsigned)(step >> 32),
                                        (unsigned)(p >> 1)),
                             prm.k0, prm.k1);
      }
      const float eta = (p & 1) ? box_muller(bits.z, bits.w)
                                : box_muller(bits.x, bits.y);
      const float var = __fmul_rn(__fmul_rn(prm.dg[p], rho[p]), c);
      // NaN passes through the clip, as in torch.clamp and jnp.maximum
      const float amp = __fsqrt_rn(var < 0.0f ? 0.0f : var);
      const float quarter = __fdiv_rn(__fmul_rn(prm.dg[p], c), 4.0f);
      r = __fadd_rn(r, __fadd_rn(
          __fmul_rn(amp, eta),
          __fmul_rn(quarter, __fsub_rn(__fmul_rn(eta, eta), 1.0f))));
    }
    react[p] = r;
    consumed = p ? __fadd_rn(consumed, r) : r;
  }
  react[P] = -consumed;
#pragma unroll
  for (int p = 0; p < F; ++p) {
    float s[9];
    pull(p, s);
    const float om = prm.omega[p];
    const float A = __fsub_rn(1.0f, om);
    const bool rho_low = rho[p] < prm.cutoff;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float feq = __fmul_rn(__fmul_rn(w[j], rho[p]), coef[j]);
      const float o = __fadd_rn(
          __fadd_rn(__fmul_rn(s[j], A), __fmul_rn(om, feq)),
          __fmul_rn(w[j], react[p]));
      // negative or NaN -> 0 (o >= 0 is false for NaN)
      put(j, p, rho_low || !(o >= 0.0f) ? 0.0f : o);
    }
  }
}

}  // namespace
