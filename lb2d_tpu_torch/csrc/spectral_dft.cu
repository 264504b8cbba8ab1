// K8 for Hopper (sm_90a): batched 1-D DFTs along the lines of a 2-D array,
// with the screened-gradient prologue and the scaled planar epilogue.
//
// Replaces lb2d_tpu/ops/dft_pallas.py:make_axis0_dft (its four passes make
// screened_gradients_pl, :497). The TPU kernel is a Bailey 4-step by MXU
// matmuls with in-VMEM corner turns, because that TPU has no FFT; none of
// that is carried over. Here one launch transforms `lines` lines of n points
// each, a block holding L whole lines in shared memory (two ping-pong
// buffers of L n complex values; lines too long for 227 KB use a scratch
// buffer in device memory instead, one block per line):
//
// - load: each value of the block's lines from real, planar or interleaved
//   complex input at any element and line stride (adjacent lines adjacent
//   in memory are read line-fastest, so a block of columns reads whole
//   row segments), or, for the screen prologue, the screened-gradient
//   spectrum P = i ax C - ay C of a half spectrum (C = X s, s = 1 / (lam2
//   (kx^2 + ky^2) + 1), ax = 2 pi gx, ay = 2 pi gy with the Nyquist bins of
//   g zeroed, the rows above ny / 2 mirrored from conj(X) by Hermitian
//   symmetry), exactly dft_pallas.py's prologue (:321-376) in one step;
// - a Stockham autosort FFT in shared memory, one stage per radix of n
//   (8, 4, 2, 3, 5, 7, then each prime factor left as its own stage): a
//   thread takes a whole radix-2, 4 or 8 butterfly (its inputs times the
//   twiddles, a hand-written DFT in registers), or, for any other radix,
//   one output as a length-R sum. Each twiddle exp(-+2 pi i q / N) comes
//   from sincospif of the exact integer phase q = (r j) mod N, exact in
//   float32 for the power-of-two N of the large grids, so that n = 8192
//   keeps ~1e-6 relative accuracy (dft_pallas.py:_consts builds its
//   matrices from integer phases too);
// - store: the first out_rows outputs of each line, times out_scale (1 / n
//   folded in for an inverse), to planar or interleaved complex output.
//
// The screened-gradient solve of rho[ny][nx] is four launches of this
// kernel (lb2d_tpu_torch/ops/spectral.py:screened_gradients): forward along
// y (real input, half spectrum of ny / 2 + 1 rows), forward along x in
// place, the screen prologue + inverse along x, and the inverse along y
// writing s (xg, yg) as two planes.
//
// Bound: bytes. At 8192^2 the four passes read and write 2.99 GB in all
// (0.89 ms at 3.35 TB/s); a radix-8 stage costs about 15 flops per point
// and one sincospif per point, well under the bytes. The column passes
// read one value per row from each line, and a
// block of 1024 threads holds a whole 8192-point line (128 KB), one block
// per SM; tiles of several columns, a register-resident radix-16 FFT and
// TMA loads are later work (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kFftMaxRadices = 32;
constexpr int kFftMaxThreads = 1024;
constexpr int kFftMaxSmem = 232448;  // the H100's 227 KB per block
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

}  // namespace

// Lb2dFftParams.in_kind / out_kind
constexpr int kFftReal = 0;         // in0: float
constexpr int kFftPlanar = 1;       // in0 / out0 real parts, in1 / out1 imag
constexpr int kFftInterleaved = 2;  // in0 / out0: float2
constexpr int kFftScreen = 3;       // in0: half spectrum X[hy][n] (float2)

// One launch (ctypes mirror: lb2d_tpu_torch/ops/_build.py:FftParams; the
// two change together). Value e of line l lives at l in_line + e in_elem
// (in elements of its kind); the screen prologue reads X row-major and its
// lines are the rows ky = 0 .. ny - 1 of the full spectrum. A launch runs
// ceil(lines / lines_per_block) blocks of `threads` threads.
struct Lb2dFftParams {
  long long in_elem, in_line, out_elem, out_line;
  int n, lines, out_rows, lines_per_block, threads;
  int in_kind, out_kind, inverse;
  float out_scale;
  int ny, hy;  // screen: the grid's rows and the half spectrum's
  float lam2;
  int num_radices;
  int radices[kFftMaxRadices];
};

namespace {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a times -i (forward) or +i (inverse)
__device__ __forceinline__ float2 rot(float2 a, bool inverse) {
  return inverse ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// exp(-+2 pi i idx / N), 0 <= idx < N: the angle from the exact integer
// phase (2 idx / N is exact in float32 for N a power of two)
__device__ __forceinline__ float2 twiddle(int idx, int N, bool inverse) {
  float s, c;
  sincospif((float)(2 * idx) / (float)N, &s, &c);
  return make_float2(c, inverse ? s : -s);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3, bool inverse) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = rot(csub(a1, a3), inverse);
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// The R-point DFT of v in registers (R = 2, 4, 8)
template <int R>
__device__ __forceinline__ void dft_regs(float2 (&v)[R], bool inverse) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3], inverse);
  } else {  // 8: two 4-point DFTs and the W_8^k twiddles
    dft4(v[0], v[2], v[4], v[6], inverse);
    dft4(v[1], v[3], v[5], v[7], inverse);
    constexpr float h = 0.70710678118654752f;
    const float2 o1 = v[3], o3 = v[7];
    const float2 w1 = inverse
                          ? make_float2(h * (o1.x - o1.y), h * (o1.x + o1.y))
                          : make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));
    const float2 w2 = rot(v[5], inverse);
    const float2 w3 = inverse
                          ? make_float2(-h * (o3.x + o3.y), h * (o3.x - o3.y))
                          : make_float2(h * (o3.y - o3.x), -h * (o3.x + o3.y));
    // the even half's outputs k sit in v[0], v[2], v[4], v[6]
    const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, w1);
    v[5] = csub(e1, w1);
    v[2] = cadd(e2, w2);
    v[6] = csub(e2, w2);
    v[3] = cadd(e3, w3);
    v[7] = csub(e3, w3);
  }
}

// One Stockham stage of radix R = 2, 4 or 8 on nl lines of n points, src ->
// dst, one thread per butterfly j: its R inputs src[j + r n / R] times
// exp(-+2 pi i r jm / (Ns R)) (jm = j mod Ns), an R-point DFT, the outputs
// at (j - jm) R + jm + k Ns.
template <int R>
__device__ __forceinline__ void fft_butterflies(const float2* src,
                                                float2* dst, int n, int Ns,
                                                bool inverse, int nl) {
  const int m = n / R;
  const int total = nl * m;
  for (int b = threadIdx.x; b < total; b += blockDim.x) {
    const int l = b / m, j = b - l * m;
    const int jm = j % Ns;
    const float2* s = src + (size_t)l * n + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[(size_t)r * m];
    if (Ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], twiddle(r * jm, Ns * R, inverse));
    }
    dft_regs<R>(v, inverse);
    float2* d = dst + (size_t)l * n + (size_t)(j - jm) * R + jm;
#pragma unroll
    for (int k = 0; k < R; ++k) d[(size_t)k * Ns] = v[k];
  }
}

// One Stockham stage of any radix R (3, 5, 7 and the primes left), one
// thread per output e = (jq R + k) Ns + jm: the sum over r of
// src[j + r n / R] exp(-+2 pi i (r p mod Ns R) / (Ns R)), j = jq Ns + jm,
// p = jm + k Ns.
__device__ __forceinline__ void fft_stage_any(const float2* src, float2* dst,
                                              int n, int Ns, int R,
                                              bool inverse, int nl) {
  const int m = n / R;
  const int NsR = Ns * R;
  const int total = nl * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = i / n, e = i - l * n;
    const int t = e / Ns, jm = e - t * Ns;
    const int jq = t / R, k = t - jq * R;
    const int p = jm + k * Ns;
    const float2* s = src + (size_t)l * n + (size_t)jq * Ns + jm;
    float2 acc = s[0];
    int idx = p;  // (r p) mod Ns R
    for (int r = 1; r < R; ++r) {
      acc = cadd(acc, cmul(s[(size_t)r * m], twiddle(idx, NsR, inverse)));
      idx += p;
      if (idx >= NsR) idx -= NsR;
    }
    dst[i] = acc;
  }
}

// The signed frequency fftfreq(n)[k] n
__device__ __forceinline__ int freq(int k, int n) {
  return k <= (n - 1) / 2 ? k : k - n;
}

// P = A + i B at (ky, kx) of the full spectrum from the half spectrum X:
// C = X s (conj(X) at the mirrored (-ky, -kx) above ny / 2), A = i ax C,
// B = i ay C, in the plain solve's operation order
// (lb2d_tpu_torch/ops/spectral.py:screened_gradients_reference).
__device__ __forceinline__ float2 screen_load(const Lb2dFftParams& p,
                                              const float2* __restrict__ X,
                                              int ky, int kx) {
  const int nx = p.n, ny = p.ny;
  const int ikx = freq(kx, nx), iky = freq(ky, ny);
  const float fkx = (float)ikx, fky = (float)iky;
  const float gx = ((nx & 1) == 0 && kx == nx / 2) ? 0.0f : fkx;
  const float gy = ((ny & 1) == 0 && ky == ny / 2) ? 0.0f : fky;
  float2 c;
  if (ky < p.hy) {
    c = X[(size_t)ky * nx + kx];
  } else {
    const float2 z = X[(size_t)(ny - ky) * nx + (kx == 0 ? 0 : nx - kx)];
    c = make_float2(z.x, -z.y);
  }
  const float s = 1.0f / (p.lam2 * (fkx * fkx + fky * fky) + 1.0f);
  const float cr = c.x * s, ci = c.y * s;
  const float ax = kTwoPi * gx, ay = kTwoPi * gy;
  return make_float2(-(ci * ax) - cr * ay, cr * ax - ci * ay);
}

__device__ __forceinline__ float2 load_value(const Lb2dFftParams& p,
                                             const void* in0, const void* in1,
                                             int line, int e) {
  if (p.in_kind == kFftScreen)
    return screen_load(p, static_cast<const float2*>(in0), line, e);
  const size_t o = (size_t)line * p.in_line + (size_t)e * p.in_elem;
  if (p.in_kind == kFftReal)
    return make_float2(static_cast<const float*>(in0)[o], 0.0f);
  if (p.in_kind == kFftInterleaved) return static_cast<const float2*>(in0)[o];
  return make_float2(static_cast<const float*>(in0)[o],
                     static_cast<const float*>(in1)[o]);
}

__device__ __forceinline__ void store_value(const Lb2dFftParams& p, void* out0,
                                            void* out1, int line, int e,
                                            float2 v) {
  const size_t o = (size_t)line * p.out_line + (size_t)e * p.out_elem;
  v.x *= p.out_scale;
  v.y *= p.out_scale;
  if (p.out_kind == kFftPlanar) {
    static_cast<float*>(out0)[o] = v.x;
    static_cast<float*>(out1)[o] = v.y;
  } else {
    static_cast<float2*>(out0)[o] = v;
  }
}

// In and out may be the same array (the forward x pass runs in place): a
// block reads all its lines before it writes any, and no two blocks share a
// line.
__global__ void __launch_bounds__(kFftMaxThreads)
fft_lines_kernel(const void* in0, const void* in1, void* out0, void* out1,
                 float2* scratch, Lb2dFftParams p) {
  extern __shared__ float2 smem[];
  const int n = p.n, L = p.lines_per_block;
  const int line0 = blockIdx.x * L;
  const int nl = min(L, p.lines - line0);
  float2* a = scratch ? scratch + (size_t)blockIdx.x * 2 * L * n : smem;
  float2* b = a + (size_t)L * n;

  const int total = nl * n;
  const bool lines_adjacent_in = p.in_line == 1 && p.in_kind != kFftScreen;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int l, e;
    if (lines_adjacent_in) {
      e = i / nl;
      l = i - e * nl;
    } else {
      l = i / n;
      e = i - l * n;
    }
    a[(size_t)l * n + e] = load_value(p, in0, in1, line0 + l, e);
  }
  __syncthreads();

  int Ns = 1;
  for (int st = 0; st < p.num_radices; ++st) {
    const int R = p.radices[st];
    const bool inv = p.inverse != 0;
    switch (R) {
      case 2: fft_butterflies<2>(a, b, n, Ns, inv, nl); break;
      case 4: fft_butterflies<4>(a, b, n, Ns, inv, nl); break;
      case 8: fft_butterflies<8>(a, b, n, Ns, inv, nl); break;
      default: fft_stage_any(a, b, n, Ns, R, inv, nl); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    Ns *= R;
  }

  const int rows = p.out_rows;
  const int total_out = nl * rows;
  const bool lines_adjacent_out = p.out_line == 1;
  for (int i = threadIdx.x; i < total_out; i += blockDim.x) {
    int l, e;
    if (lines_adjacent_out) {
      e = i / nl;
      l = i - e * nl;
    } else {
      l = i / rows;
      e = i - l * rows;
    }
    store_value(p, out0, out1, line0 + l, e, a[(size_t)l * n + e]);
  }
}

}  // namespace

// One K8 launch: p.lines DFTs of p.n points (see Lb2dFftParams). scratch:
// NULL (shared memory) or 2 lines_per_block n float2 per block in device
// memory. Launches on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_fft_lines(const void* in0, const void* in1, void* out0,
                              void* out1, void* scratch, Lb2dFftParams p,
                              void* stream) {
  if (p.n < 1 || p.lines < 1 || p.lines_per_block < 1 || p.threads < 32 ||
      p.threads > kFftMaxThreads || p.out_rows < 1 || p.out_rows > p.n ||
      p.num_radices < 0 || p.num_radices > kFftMaxRadices)
    return (int)cudaErrorInvalidValue;
  long long prod = 1;
  for (int i = 0; i < p.num_radices; ++i) {
    if (p.radices[i] < 2) return (int)cudaErrorInvalidValue;
    prod *= p.radices[i];
  }
  if (prod != p.n) return (int)cudaErrorInvalidValue;
  const size_t smem =
      scratch ? 0 : (size_t)2 * p.lines_per_block * p.n * sizeof(float2);
  if (smem > (size_t)kFftMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_opted_in = false;
  if (!smem_opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFftMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_opted_in = true;
  }
  const long long blocks =
      ((long long)p.lines + p.lines_per_block - 1) / p.lines_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fft_lines_kernel<<<(unsigned)blocks, p.threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in0, in1, out0, out1, static_cast<float2*>(scratch), p);
  return (int)cudaGetLastError();
}

// sizeof(Lb2dFftParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_fft_params_size() {
  return (int)sizeof(Lb2dFftParams);
}
