// Standard normals of one global step, for Hopper (sm_90a): P1.
//
// Replaces benchmarks/tpu_tests.py:_kernel_normals, the probe that draws
// the TPU's on-core PRNG normals (pltpu.prng_random_bits + Box-Muller,
// lb2d_tpu/ops/fused.py:295-302) into an array so that their statistics can
// be tested. Here the generator is the counter-based Philox of philox.cuh,
// and lb2d_normals fills out[cell] with exactly the normal that the noisy
// kernels (temporal_step.cu, resident_run.cu) draw for that cell at that
// step. lb2d_philox_bits writes the four raw Philox words instead, through
// the same Philox code, so the integer part can be held to the plain
// version (ops/random.py) bit for bit.
//
// Bound: instruction issue. A cell writes 4 B against ten Philox rounds (a
// 32 x 32 -> 64-bit multiply pair and two 3-way xors each) and logf, sqrtf,
// cosf: 133 SASS instructions on a cell's path in the first one-cell-a-
// thread loop (kept as lb2d_normals_per_cell, for the tests). Every counter
// of a launch is (cell, step mod 2^32, step >> 32, 0), so the ten round
// keys, round 1's product of word 2 and the words 0 and 1 it yields, and
// round 2's product of word 0 are the launch's: the host computes them once
// (PhiloxLaunch) and the kernel reads them as operands from the constant
// bank. A thread computes four consecutive cells and writes them with one
// 16-byte store; the cells before out's first 16-byte boundary and after the
// last whole quad take one thread each. Box-Muller is philox.cuh's, so every
// normal is the bit the noisy kernels draw. Its precise logf, sqrtf and
// cosf are now most of a cell's path; PERF.md (section 6) has the
// SASS counts of both loops (tools/sass_count.py) and their times, and
// those of the variants that tools/p1_variants.py builds (one, two and
// eight cells a thread, a capped grid, a float4 store through a cast
// pointer).

#include "philox.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kCells = 4;  // consecutive cells a thread, one 16-byte store

// What every counter (cell, step mod 2^32, step >> 32, 0) of one launch
// shares under key (k0[0], k1[0]): the round keys, words 0 and 1 after
// round 1 (x1, y1), and round 2's product of x1 (hi2, lo2)
struct PhiloxLaunch {
  unsigned k0[10], k1[10];
  unsigned x1, y1, hi2, lo2;
};

PhiloxLaunch philox_launch(unsigned long long step, unsigned key0,
                           unsigned key1) {
  PhiloxLaunch L;
  for (int r = 0; r < 10; ++r) {
    L.k0[r] = key0 + (unsigned)r * kPhiloxW0;
    L.k1[r] = key1 + (unsigned)r * kPhiloxW1;
  }
  const unsigned long long z = (unsigned long long)kPhiloxM1 *
                               (unsigned)(step >> 32);
  L.x1 = (unsigned)(z >> 32) ^ (unsigned)step ^ L.k0[0];
  L.y1 = (unsigned)z;
  const unsigned long long x = (unsigned long long)kPhiloxM0 * L.x1;
  L.hi2 = (unsigned)(x >> 32);
  L.lo2 = (unsigned)x;
  return L;
}

// philox4x32_10({cell, step mod 2^32, step >> 32, 0}, key) of the launch L
__device__ __forceinline__ uint4 philox_cell(const PhiloxLaunch& L,
                                             unsigned cell) {
  // round 1: words 2 and 3 are the launch's
  uint4 c = make_uint4(L.x1, L.y1, __umulhi(kPhiloxM0, cell) ^ L.k1[0],
                       kPhiloxM0 * cell);
  // round 2: word 0 is the launch's
  c = make_uint4(__umulhi(kPhiloxM1, c.z) ^ c.y ^ L.k0[1], kPhiloxM1 * c.z,
                 L.hi2 ^ c.w ^ L.k1[1], L.lo2);
#pragma unroll
  for (int r = 2; r < 10; ++r) {
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ L.k0[r], lo1, hi0 ^ c.w ^ L.k1[r], lo0);
  }
  return c;
}

__device__ __forceinline__ float normal_of(const PhiloxLaunch& L,
                                           long long i) {
  const uint4 b = philox_cell(L, (unsigned)i);
  return box_muller(b.x, b.y);
}

// out[i] = cell_normal(i, step, key), i < n: cells [0, head) and [head + 4
// quads, n) one a thread (thread g < head + tail), quad q = cells [head +
// 4 q, head + 4 q + 4) on thread q of a grid-stride loop
__global__ void __launch_bounds__(kBlock)
normals_kernel(float* __restrict__ out, long long n, int head,
               long long quads, PhiloxLaunch L) {
  const long long g = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long q = g; q < quads; q += stride) {
    const long long i = head + kCells * q;
    float v[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) v[k] = normal_of(L, i + k);
    // in PTX: a float4 store through a cast pointer came out of ptxas as
    // four 4-byte stores, each issued as soon as its cell was done
    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out + i),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  }
  const long long body = head + kCells * quads;
  if (g < head + (n - body)) {
    const long long i = g < head ? g : body + (g - head);
    out[i] = normal_of(L, i);
  }
}

// the first P1 loop, one cell a thread through philox.cuh's cell_normal:
// the tests hold normals_kernel to it bit for bit
__global__ void __launch_bounds__(kBlock)
normals_per_cell_kernel(float* __restrict__ out, long long n, unsigned k0,
                        unsigned k1, unsigned long long step) {
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride)
    out[i] = cell_normal((unsigned long long)i, step, k0, k1);
}

__global__ void __launch_bounds__(kBlock)
philox_bits_kernel(unsigned* __restrict__ out, long long n, PhiloxLaunch L) {
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride) {
    const uint4 b = philox_cell(L, (unsigned)i);
    out[i] = b.x;
    out[n + i] = b.y;
    out[2 * n + i] = b.z;
    out[3 * n + i] = b.w;
  }
}

int grid_for(long long threads) {
  const long long blocks = (threads + kBlock - 1) / kBlock;
  return (int)(blocks < 65536 ? blocks : 65536);
}

}  // namespace

// out[i] = the standard normal of cell i at global step `step` under the
// Philox key (key0, key1), i < n. out: n float32, 4-byte aligned. Launches
// on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_normals(float* out, long long n, unsigned key0,
                            unsigned key1, unsigned long long step,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  // cells before the first 16-byte boundary of out, then whole quads
  const long long to_boundary = (16 - (long long)((size_t)out % 16)) % 16 / 4;
  const int head = (int)(to_boundary < n ? to_boundary : n);
  const long long quads = (n - head) / kCells;
  const long long ragged = n - kCells * quads;
  normals_kernel<<<grid_for(quads > ragged ? quads : ragged), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      out, n, head, quads, philox_launch(step, key0, key1));
  return (int)cudaGetLastError();
}

// The same normals from the first one-cell-a-thread loop, for the tests;
// arguments and result as lb2d_normals.
extern "C" int lb2d_normals_per_cell(float* out, long long n, unsigned key0,
                                     unsigned key1, unsigned long long step,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  normals_per_cell_kernel<<<grid_for(n), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      out, n, key0, key1, step);
  return (int)cudaGetLastError();
}

// out[w * n + i] = word w of philox4x32_10({i, step mod 2^32, step >> 32,
// 0}, key), i < n. out: 4 n uint32. Launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int lb2d_philox_bits(unsigned* out, long long n, unsigned key0,
                                unsigned key1, unsigned long long step,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_bits_kernel<<<grid_for(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      out, n, philox_launch(step, key0, key1));
  return (int)cudaGetLastError();
}
