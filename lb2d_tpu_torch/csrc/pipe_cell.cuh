// The per-cell D2Q9 pipe-flow update, shared by the port's flow kernels
// (pipe_step.cu, temporal_step.cu, resident_run.cu).
//
// cell_update is the tile math of lb2d_tpu/ops/fused.py:56-215 written for
// one cell: from the 9 values that cell (y, x) pulled in the stream, apply
// the Zou-He pressure inlet/outlet, the solid walls and the four corners by
// cell class (reading only its own pulled values: the snapshot semantics
// of _zou_he_tile, fused.py:56-130), then full bounce-back inside an
// obstacle (fused.py:147-151), the moments (with the incompressible
// equilibrium u and v are zeroed inside the mask, fused.py:170-173), feq
// per direction and BGK. velocity_cell_update is the same step with the
// velocity-inlet BCs of _velocity_inlet_tile (fused.py:334-354) and of
// ops/boundary.py, periodic in y. diffusion_cell_update is the step of the
// periodic advection-diffusion family (fused.py:250-270 and 1019-1041):
// linear feq, BGK, Fisher growth and, with kNoisy, multiplicative noise
// from philox.cuh and the negativity clip.
//
// Numerics: no fast math (IEEE division, denormals kept). Expressions
// follow the JAX float32 order term by term; in the flow updates nvcc may
// contract a multiply and an add into one FMA, so results differ from the
// plain PyTorch step by a few ulp. Every flow update (collide) multiplies
// where the plain step divides by float32's cs2, 2 cs2 cs2 and 2 cs2: by 3,
// 4.5 and 1.5, the exact reciprocals of 1/3, 2/9 and 2/3, one rounding
// each, which the quotients by the rounded constants only approximate. The
// diffusion update rounds every operation on its own and matches the plain
// step bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "philox.cuh"

namespace {

// The scalars of one launch, by physics. a, b: inlet and outlet density
// (flow), inlet and outlet velocity (velocity inlet), or the imposed
// lattice velocity u, v (diffusion family). g, dg: Fisher growth and noise
// amplitude; k0, k1: Philox key; step0: global step of the launch's first
// step (diffusion family only).
struct StepParams {
  float omega, a, b, g, dg;
  unsigned k0, k1;
  unsigned long long step0;
};

constexpr float kW0 = (float)(4.0 / 9.0);
constexpr float kW1 = (float)(1.0 / 9.0);
constexpr float kW2 = (float)(1.0 / 36.0);
constexpr float kCs2 = (float)(1.0 / 3.0);
// 1 / cs2, 1 / (2 cs4) and 1 / (2 cs2) of the exact cs2 = 1/3, exact in
// float32 (collide)
constexpr float kInvCs2 = 3.0f;
constexpr float kInvTwoCs4 = 4.5f;
constexpr float kInvTwoCs2 = 1.5f;
constexpr float kTwoThirds = (float)(2.0 / 3.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kSixth = (float)(1.0 / 6.0);

// Pull the 9 values of cell (y, x) from f[9][ny][nx] with periodic wrap:
// s_j = f[j, (y - cy_j) mod ny, (x - cx_j) mod nx], D2Q9 numbering
// cx = 0 1 0 -1 0 1 -1 -1 1, cy = 0 0 1 0 -1 1 1 -1 -1.
// kL2 loads through L2 only (ld.global.cg): for buffers that other blocks
// wrote earlier in the same launch, which a stale L1 line must not serve.
template <bool kL2 = false>
__device__ __forceinline__ void pull(const float* f, int y, int x, int ny,
                                     int nx, float (&s)[9]) {
  const size_t plane = (size_t)ny * nx;
  const int xm = x == 0 ? nx - 1 : x - 1;   // source column for cx = +1
  const int xp = x == nx - 1 ? 0 : x + 1;   // source column for cx = -1
  const int ym = y == 0 ? ny - 1 : y - 1;   // source row for cy = +1
  const int yp = y == ny - 1 ? 0 : y + 1;   // source row for cy = -1
  const size_t r0 = (size_t)y * nx, rm = (size_t)ym * nx, rp = (size_t)yp * nx;
  const size_t at[9] = {0 * plane + r0 + x,  1 * plane + r0 + xm,
                        2 * plane + rm + x,  3 * plane + r0 + xp,
                        4 * plane + rp + x,  5 * plane + rm + xm,
                        6 * plane + rm + xp, 7 * plane + rp + xp,
                        8 * plane + rp + xm};
#pragma unroll
  for (int j = 0; j < 9; ++j) s[j] = kL2 ? __ldcg(f + at[j]) : f[at[j]];
}

// Zou-He BCs on the pulled values of cell (y, x), fused.py:56-130.
template <bool kIncomp>
__device__ __forceinline__ void apply_bcs(const float (&s)[9], float (&st)[9],
                                          int y, int x, int ny, int nx,
                                          float rin, float rout) {
  const bool lane0 = x == 0, laneN = x == nx - 1;
  const bool row0 = y == 0, rowN = y == ny - 1;
  if (!(row0 || rowN)) {
    if (lane0) {
      if (kIncomp) {  // D2Q9i.cl:194-199
        const float u_in = -s[0] - s[2] - 2.0f * s[3] - s[4] - 2.0f * s[6]
                           - 2.0f * s[7] + rin;
        st[1] = kThird * (3.0f * s[3] + 2.0f * u_in);
        st[5] = kSixth * (-3.0f * s[2] + 3.0f * s[4] + 6.0f * s[7] + u_in);
        st[8] = kSixth * (3.0f * s[2] - 3.0f * s[4] + 6.0f * s[6] + u_in);
      } else {  // D2Q9.cl:198-203
        const float u_in = -((s[0] + s[2] + 2.0f * s[3] + s[4] + 2.0f * s[6]
                              + 2.0f * s[7] - rin) / rin);
        st[1] = s[3] + kTwoThirds * rin * u_in;
        st[5] = -0.5f * s[2] + 0.5f * s[4] + s[7] + kSixth * u_in * rin;
        st[8] = 0.5f * s[2] - 0.5f * s[4] + s[6] + kSixth * u_in * rin;
      }
    } else if (laneN) {
      if (kIncomp) {  // D2Q9i.cl:201-206
        const float u_out = s[0] + 2.0f * s[1] + s[2] + s[4] + 2.0f * s[5]
                            + 2.0f * s[8] - rout;
        st[3] = kThird * (3.0f * s[1] - 2.0f * u_out);
        st[6] = kSixth * (-3.0f * s[2] + 3.0f * s[4] + 6.0f * s[8] - u_out);
        st[7] = kSixth * (3.0f * s[2] - 3.0f * s[4] + 6.0f * s[5] - u_out);
      } else {  // D2Q9.cl:205-210
        const float u_out = -1.0f + (s[0] + 2.0f * s[1] + s[2] + s[4]
                                     + 2.0f * s[5] + 2.0f * s[8]) / rout;
        st[3] = s[1] - kTwoThirds * rout * u_out;
        st[6] = -0.5f * s[2] + 0.5f * s[4] + s[8] - kSixth * u_out * rout;
        st[7] = 0.5f * s[2] - 0.5f * s[4] + s[5] - kSixth * u_out * rout;
      }
    }
    return;
  }
  if (!(lane0 || laneN)) {  // walls, D2Q9.cl:212-223
    if (rowN) {
      st[4] = s[2];
      st[8] = 0.5f * (-s[1] + s[3] + 2.0f * s[6]);
      st[7] = 0.5f * (s[1] - s[3] + 2.0f * s[5]);
    } else {
      st[2] = s[4];
      st[6] = 0.5f * (s[1] - s[3] + 2.0f * s[8]);
      st[5] = 0.5f * (-s[1] + s[3] + 2.0f * s[7]);
    }
    return;
  }
  // corners, D2Q9.cl:228-259
  if (row0 && lane0) {
    const float d = 0.5f * (-s[0] - 2.0f * s[3] - 2.0f * s[4] - 2.0f * s[7] + rin);
    st[1] = s[3]; st[2] = s[4]; st[5] = s[7]; st[6] = d; st[8] = d;
  } else if (rowN && lane0) {
    const float d = 0.5f * (-s[0] - 2.0f * s[2] - 2.0f * s[3] - 2.0f * s[6] + rin);
    st[1] = s[3]; st[4] = s[2]; st[8] = s[6]; st[5] = d; st[7] = d;
  } else if (row0) {  // && laneN
    const float d = 0.5f * (-s[0] - 2.0f * s[1] - 2.0f * s[4] - 2.0f * s[8] + rout);
    st[3] = s[1]; st[2] = s[4]; st[6] = s[8]; st[5] = d; st[7] = d;
  } else {  // rowN && laneN
    const float d = 0.5f * (-s[0] - 2.0f * s[1] - 2.0f * s[2] - 2.0f * s[5] + rout);
    st[3] = s[1]; st[4] = s[2]; st[7] = s[5]; st[6] = d; st[8] = d;
  }
}

// Full bounce-back (opposites 0 3 4 1 2 7 8 5 6).
__device__ __forceinline__ void bounce_back(float (&st)[9]) {
  float t;
  t = st[1]; st[1] = st[3]; st[3] = t;
  t = st[2]; st[2] = st[4]; st[4] = t;
  t = st[5]; st[5] = st[7]; st[7] = t;
  t = st[6]; st[6] = st[8]; st[8] = t;
}

// Moments, feq and BGK on the post-BC values st. The moments are summed in
// direction order as the plain version sums them; u = j / rho, or u = j
// with kIncompMoments (He-Luo); u = v = 0 when zero_vel. feq is the
// quadratic (compressible) or, with kIncompFeq, the incompressible one. No
// division by a constant: c.u / cs2 is cu * 3, (c.u)^2 / (2 cs4) is
// cu^2 * 4.5 and u^2 / (2 cs2) is (u^2 + v^2) * 1.5, and the opposite
// directions share their terms, (-c) * k = -(c * k) and (-c)^2 = c^2
// exactly. Without fast math each division is a reciprocal, a Newton step
// and a checked branch to a slow path, about ten instructions that end a
// basic block; 1 / rho stays one correctly rounded reciprocal.
template <bool kIncompMoments, bool kIncompFeq>
__device__ __forceinline__ void collide(const float (&st)[9], float (&out)[9],
                                        bool zero_vel, float omega) {
  const float rho = st[0] + st[1] + st[2] + st[3] + st[4] + st[5] + st[6]
                    + st[7] + st[8];
  const float jx = st[1] - st[3] + st[5] - st[6] - st[7] + st[8];
  const float jy = st[2] - st[4] + st[5] + st[6] - st[7] - st[8];
  float u, v;
  if (kIncompMoments) {
    u = jx;
    v = jy;
  } else {
    const float inv = 1.0f / rho;
    u = jx * inv;
    v = jy * inv;
  }
  if (zero_vel) {
    u = 0.0f;
    v = 0.0f;
  }
  const float A = 1.0f - omega;
  const float usq = (u * u + v * v) * kInvTwoCs2;
  const float cu[9] = {0.0f, u, v, -u, -v, u + v, -u + v, -u - v, u - v};
  const float w[9] = {kW0, kW1, kW1, kW1, kW1, kW2, kW2, kW2, kW2};
  float lin[9], sq[9];  // cu / cs2 and cu^2 / (2 cs4) per direction
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    // directions 3, 4, 7, 8 are the opposites of 1, 2, 5, 6
    const int o = j == 3 ? 1 : j == 4 ? 2 : j == 7 ? 5 : j == 8 ? 6 : j;
    if (o != j) {
      lin[j] = -lin[o];
      sq[j] = sq[o];
    } else {
      lin[j] = cu[j] * kInvCs2;
      sq[j] = (cu[j] * cu[j]) * kInvTwoCs4;
    }
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float feq;
    if (kIncompFeq) {
      feq = w[j] * (rho + lin[j] + sq[j] - usq);
    } else {
      feq = w[j] * rho * (1.0f + lin[j] + sq[j] - usq);
    }
    out[j] = st[j] * A + omega * feq;
  }
}

// One pressure-driven step of cell (y, x) from its pulled values s to its
// post-collision values out: BCs, bounce-back if `solid`, moments, feq,
// BGK. The incompressible equilibrium uses He-Luo moments and zeroes the
// velocity inside the obstacle.
template <bool kIncomp, bool kObstacle>
__device__ __forceinline__ void cell_update(const float (&s)[9],
                                            float (&out)[9], int y, int x,
                                            int ny, int nx, bool solid,
                                            float omega, float rin,
                                            float rout) {
  float st[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) st[j] = s[j];
  apply_bcs<kIncomp>(s, st, y, x, ny, nx, rin, rout);
  if (kObstacle && solid) bounce_back(st);  // from the post-BC snapshot
  collide<kIncomp, kIncomp>(st, out, kIncomp && kObstacle && solid, omega);
}

// Zou-He velocity inlet (u = uw) on the whole column x = 0 and, on
// x = nx - 1, the Zou-He velocity outlet (u = ue) with kPair, or else the
// zero-gradient open outlet: directions 3, 6, 7 take what the upstream
// cell (y, nx - 2) pulled, which for these left-moving directions is
// f[3, y, nx-1], f[6, y-1, nx-1], f[7, y+1, nx-1] of the pre-stream f
// (`up`). Periodic in y. ops/boundary.py: zou_he_velocity_bcs and
// zou_he_velocity_inlet_open_outlet.
template <bool kPair>
__device__ __forceinline__ void apply_velocity_bcs(const float (&s)[9],
                                                   const float (&up)[3],
                                                   float (&st)[9], int x,
                                                   int nx, float uw,
                                                   float ue) {
  if (x == 0) {  // D2Q9.cl:291-296
    const float rho_w = (1.0f / (1.0f - uw))
                        * (s[0] + s[2] + s[4] + 2.0f * (s[3] + s[6] + s[7]));
    st[1] = s[3] + kTwoThirds * rho_w * uw;
    st[5] = s[7] - 0.5f * (s[2] - s[4]) + kSixth * rho_w * uw;
    st[8] = s[6] + 0.5f * (s[2] - s[4]) + kSixth * rho_w * uw;
  }
  if (x == nx - 1) {
    if (kPair) {  // D2Q9.cl:298-303
      const float rho_e = (1.0f / (1.0f + ue))
                          * (s[0] + s[2] + s[4] + 2.0f * (s[1] + s[5] + s[8]));
      st[3] = s[1] - kTwoThirds * rho_e * ue;
      st[6] = s[5] + 0.5f * (s[2] - s[4]) - kSixth * rho_e * ue;
      st[7] = s[8] - 0.5f * (s[2] - s[4]) - kSixth * rho_e * ue;
    } else {
      st[3] = up[0];
      st[6] = up[1];
      st[7] = up[2];
    }
  }
}

// One velocity-inlet step of a cell in column x (OLD/opencl.py:281-375, the fixes
// of DIVERGENCES.md #20-21): velocity BCs, bounce-back if `solid`,
// compressible moments with the velocity zeroed inside the obstacle, feq
// (incompressible with kIncompFeq), BGK.
template <bool kPair, bool kIncompFeq, bool kObstacle>
__device__ __forceinline__ void velocity_cell_update(
    const float (&s)[9], const float (&up)[3], float (&out)[9], int x, int nx,
    bool solid, float omega, float uw, float ue) {
  float st[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) st[j] = s[j];
  apply_velocity_bcs<kPair>(s, up, st, x, nx, uw, ue);
  if (kObstacle && solid) bounce_back(st);
  collide<false, kIncompFeq>(st, out, kObstacle && solid, omega);
}

// (1 + c_j.u / cs2) per direction, as feq_linear forms it: the same for
// every cell of a launch.
__device__ __forceinline__ void feq_coefficients(float u, float v,
                                                 float (&coef)[9]) {
  const float cu[9] = {0.0f, u, v, -u, -v, __fadd_rn(u, v), __fadd_rn(-u, v),
                       __fadd_rn(-u, -v), __fadd_rn(u, -v)};
#pragma unroll
  for (int j = 0; j < 9; ++j) coef[j] = __fadd_rn(1.0f, __fdiv_rn(cu[j], kCs2));
}

// One step of the periodic advection-diffusion family for the cell with
// global index `cell` at global step `step`, from its pulled values s
// (no BCs): rho = sum f in direction order, feq_j = (w_j rho)(1 + c_j.u /
// cs2), BGK, then + w_j react with react = g rho (1 - rho), plus with
// kNoisy sqrt(max(dg rho (1 - rho), 0)) eta and the clip max(f, 0)
// (D2Q9_diffusion.cl:95-167), in the order of lb2d_tpu_torch/ops/fused.py's
// plain steps. Every operation rounds on its own (__fmul_rn and __fadd_rn
// are never contracted into FMAs), so the update equals the plain step's
// separate torch operations bit for bit. The noise needs that:
// sqrt(rho (1 - rho)) has an unbounded slope at rho = 1, where one ulp of
// rho moves the noise by up to ~1e-5. With g = 0 the growth adds an exact
// zero; with dg = 0 no normal is drawn, as the plain step draws none.
// coef: the launch's feq_coefficients(p.a, p.b) (K2 forms them once).
template <bool kNoisy>
__device__ __forceinline__ void diffusion_cell_update(
    const float (&s)[9], float (&out)[9], const StepParams& p,
    unsigned long long cell, unsigned long long step,
    const float (&coef)[9]) {
  float rho = s[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) rho = __fadd_rn(rho, s[j]);
  const float one_minus = __fsub_rn(1.0f, rho);
  float react = __fmul_rn(__fmul_rn(p.g, rho), one_minus);
  if (kNoisy && p.dg != 0.0f) {
    const float var = __fmul_rn(__fmul_rn(p.dg, rho), one_minus);
    // NaN passes through both clips, as in torch.clamp and jnp.maximum
    const float amp = __fsqrt_rn(var < 0.0f ? 0.0f : var);
    react = __fadd_rn(react,
                      __fmul_rn(amp, cell_normal(cell, step, p.k0, p.k1)));
  }
  const float A = __fsub_rn(1.0f, p.omega);
  const float w[9] = {kW0, kW1, kW1, kW1, kW1, kW2, kW2, kW2, kW2};
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float feq = __fmul_rn(__fmul_rn(w[j], rho), coef[j]);
    const float o = __fadd_rn(
        __fadd_rn(__fmul_rn(s[j], A), __fmul_rn(p.omega, feq)),
        __fmul_rn(w[j], react));
    out[j] = kNoisy && o < 0.0f ? 0.0f : o;
  }
}

// The same, forming each coefficient where it is used (K3, K9: K9's noisy
// shard ran 1.5-2% slower through the version above; PERF.md, PR 9).
template <bool kNoisy>
__device__ __forceinline__ void diffusion_cell_update(
    const float (&s)[9], float (&out)[9], const StepParams& p,
    unsigned long long cell, unsigned long long step) {
  float rho = s[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) rho = __fadd_rn(rho, s[j]);
  const float one_minus = __fsub_rn(1.0f, rho);
  float react = __fmul_rn(__fmul_rn(p.g, rho), one_minus);
  if (kNoisy && p.dg != 0.0f) {
    const float var = __fmul_rn(__fmul_rn(p.dg, rho), one_minus);
    // NaN passes through both clips, as in torch.clamp and jnp.maximum
    const float amp = __fsqrt_rn(var < 0.0f ? 0.0f : var);
    react = __fadd_rn(react,
                      __fmul_rn(amp, cell_normal(cell, step, p.k0, p.k1)));
  }
  const float A = __fsub_rn(1.0f, p.omega);
  const float u = p.a, v = p.b;
  const float cu[9] = {0.0f, u, v, -u, -v, __fadd_rn(u, v), __fadd_rn(-u, v),
                       __fadd_rn(-u, -v), __fadd_rn(u, -v)};
  const float w[9] = {kW0, kW1, kW1, kW1, kW1, kW2, kW2, kW2, kW2};
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float feq = __fmul_rn(__fmul_rn(w[j], rho),
                                __fadd_rn(1.0f, __fdiv_rn(cu[j], kCs2)));
    const float o = __fadd_rn(
        __fadd_rn(__fmul_rn(s[j], A), __fmul_rn(p.omega, feq)),
        __fmul_rn(w[j], react));
    out[j] = kNoisy && o < 0.0f ? 0.0f : o;
  }
}

}  // namespace
