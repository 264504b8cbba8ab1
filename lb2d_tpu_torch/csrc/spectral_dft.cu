// K8 for Hopper (sm_90a): the screened-gradient solve as batched 1-D DFTs
// along the lines of a 2-D array, in two designs.
//
// Replaces lb2d_tpu/ops/dft_pallas.py:make_axis0_dft (its four passes make
// screened_gradients_pl, :497). The TPU kernel is a Bailey 4-step by MXU
// matmuls with in-VMEM corner turns, because that TPU has no FFT; none of
// that is carried over.
//
// The tiled plan (second half of this file, lb2d_fft_pass) solves every
// grid whose lines factor into 2, 3, 5 and 7 with rows of at most 16,384
// points, in three or five passes that move whole row segments only.
//
// The whole-line kernel (lb2d_fft_lines, below) takes any grid: the solve
// of the others (a large prime line) and dft_axis0, the 1-D pass. One
// launch transforms `lines` lines of n points each, a block holding L
// whole lines in shared memory (two ping-pong buffers of L n complex
// values; lines too long for 227 KB use a scratch buffer in device memory
// instead, one block per line):
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
//   one output as a length-R sum. Each twiddle exp(-+2 pi i q / N), q =
//   (r j) mod N, comes from a table of W_n^m built once per n on the host
//   from the exact integer phase (dft_pallas.py:_consts builds its
//   matrices from integer phases too), and a length-R sum adds its terms
//   in double (in float32 an 8191-point line kept 2.4e-6 of its scale);
// - store: the first out_rows outputs of each line, times out_scale (1 / n
//   folded in for an inverse), to planar or interleaved complex output.
//
// Its solve of rho[ny][nx] is four launches (lb2d_tpu_torch/ops/
// spectral.py:_whole_line_passes): forward along y (real input, half
// spectrum of ny / 2 + 1 rows), forward along x in place, the screen
// prologue + inverse along x, and the inverse along y writing s (xg, yg)
// as two planes. Bound: bytes, but a column pass reads one value per row
// of each line and a prime line costs O(n^2): it is the general path, not
// the fast one (PERF.md).

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

// exp(-+2 pi i idx / N), 0 <= idx < N, N dividing the line's n: entry idx
// n / N of the line's table of W_n^m (float32 roundings of the float64
// values from the exact integer phase), or its conjugate
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int idx, int n, int N,
                                          bool inverse) {
  const float2 w = __ldg(tw + (size_t)idx * (n / N));
  return make_float2(w.x, inverse ? -w.y : w.y);
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
                                                bool inverse, int nl,
                                                const float2* tw) {
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
        v[r] = cmul(v[r], twiddle(tw, r * jm, n, Ns * R, inverse));
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
                                              bool inverse, int nl,
                                              const float2* tw) {
  const int m = n / R;
  const int NsR = Ns * R;
  const int total = nl * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = i / n, e = i - l * n;
    const int t = e / Ns, jm = e - t * Ns;
    const int jq = t / R, k = t - jq * R;
    const int p = jm + k * Ns;
    const float2* s = src + (size_t)l * n + (size_t)jq * Ns + jm;
    // summed in double: a long prime sum (8191 terms) in float32 left the
    // line at 2.4e-6 of its scale
    double ax = s[0].x, ay = s[0].y;
    int idx = p;  // (r p) mod Ns R
    for (int r = 1; r < R; ++r) {
      const float2 t =
          cmul(s[(size_t)r * m], twiddle(tw, idx, n, NsR, inverse));
      ax += t.x;
      ay += t.y;
      idx += p;
      if (idx >= NsR) idx -= NsR;
    }
    dst[i] = make_float2((float)ax, (float)ay);
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
                 float2* scratch, const float2* __restrict__ tw,
                 Lb2dFftParams p) {
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
      case 2: fft_butterflies<2>(a, b, n, Ns, inv, nl, tw); break;
      case 4: fft_butterflies<4>(a, b, n, Ns, inv, nl, tw); break;
      case 8: fft_butterflies<8>(a, b, n, Ns, inv, nl, tw); break;
      default: fft_stage_any(a, b, n, Ns, R, inv, nl, tw); break;
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
// memory; tw: the table of W_n^m (float2, m < n). Launches on `stream` and
// returns the launch's CUDA error code.
extern "C" int lb2d_fft_lines(const void* in0, const void* in1, void* out0,
                              void* out1, void* scratch, const void* tw,
                              Lb2dFftParams p, void* stream) {
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
      in0, in1, out0, out1, static_cast<float2*>(scratch),
      static_cast<const float2*>(tw), p);
  return (int)cudaGetLastError();
}

// sizeof(Lb2dFftParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_fft_params_size() {
  return (int)sizeof(Lb2dFftParams);
}

// ---------------------------------------------------------------------------
// The tiled plan (lb2d_tpu_torch/ops/spectral.py:solve_plan): the solve of
// a grid whose lines factor into 2, 3, 5 and 7, in passes that read and
// write only whole row segments:
//
// - rows (kPassRowReal): `lines` complex lines per block, line q the real
//   rows 2q + i (2q + 1) of rho, each an n = nx point DFT in shared memory,
//   the two rows' first hx = nx / 2 + 1 values separated by Hermitian
//   symmetry and stored to a half-spectrum plane H[ny][pitch];
// - column tiles (kPassCols, kPassColsScreen): a block takes `lines` (TX)
//   adjacent columns of the half-spectrum planes, so every row segment it
//   moves is TX float2 (64 B or more, the pitch a multiple of 32), and
//   transforms them along y. Columns of up to 1024 rows: one launch
//   (kPassColsScreen over the whole column). Longer: the four-step split
//   ny = n1 n2, three launches: n1-point DFTs over the rows j2 + n2 j1 of
//   group j2, times W^(-j2 k1), to rows k1 n2 + j2 (kPassCols); the
//   n2-point DFTs over the contiguous rows k1 n2 + j2 of group k1, the
//   screen, the inverse n2-point DFT of one gradient spectrum, times
//   W^(j2 k1), to rows j2 n1 + k1 (kPassColsScreen); inverse n1-point
//   DFTs over the contiguous rows j2 n1 + k1 of each plane to rows j2 + n2
//   j1 (kPassCols). gridDim.z = 2 in the last two: plane z, or for the
//   screen pass gradient z (each of its two blocks of a tile transforms
//   the tile forward itself, and keeps half the shared memory);
// - rows (kPassRowPack): the two gradient planes a, b (x still a half
//   spectrum) read forwards, packed in shared memory as Z = a + i b over
//   the whole x spectrum (Z[nx - k] = conj(a[k]) + i conj(b[k]): xg and yg
//   are real, so each row's x spectrum is Hermitian), the inverse n = nx
//   point DFT, s (xg, yg) = s Z stored as two planes.
//
// The screen sits between the forward and inverse column DFTs, pointwise
// on a tile in shared memory: s = 1 / (lam2 (kx^2 + ky^2) + 1), A = i 2 pi
// gx s X, B = i 2 pi gy s X, in the plain solve's operation order; no
// mirror is read there. Each block holds its lines in ONE shared buffer
// (rows padded, index i + i / 16, so the first stage's strided stores
// stay nearly free of bank conflicts; column tiles unpadded, lines
// adjacent) and runs the DFT in place in stages: the power of two's
// leftover radix 2, 4 or 8 first (kLeft; it needs no twiddles), then
// radix 16 (kLeft and the stage count fixed per kernel, so a thread holds
// 16 values in registers and nothing more); lines with factors 3, 5, 7
// take a kernel with any order of 16, 8, 4, 2, 3, 5, 7 (kLeft 0). Each
// thread loads its butterflies' values into registers, applies the
// twiddles and a register DFT, waits at a barrier and stores them
// (Stockham order, no bit reversal). Every twiddle comes from a table of
// W_N^m (N = nx or ny, float32 roundings of the float64 values from the
// exact integer phase, built once per N on the host): a pass of length
// n = N / s reads every s-th entry, the four-step's W^(j2 k1) entry j2 k1.
//
// Bound: bytes. At 8192^2 the five passes move 64 B per cell (rho 4 in,
// H 4 out; H 4, T 4; T 8 (read by both gradients' blocks), two planes 8;
// two planes 8, two planes 8; two planes 8, xg and yg 8): 4.3 GB, 1.28 ms
// at 3.35 TB/s. The register DFTs cost about 5 log2(N) flops per point
// and pass, far under the bytes; shared memory moves 16 B per point and
// stage.

namespace {

constexpr int kPassMaxStages = 12;
constexpr int kValues = 16;  // values a thread holds in a stage, at most

}  // namespace

// Lb2dFftPass.kind
constexpr int kPassRowReal = 0;
constexpr int kPassRowPack = 1;
constexpr int kPassCols = 2;
constexpr int kPassColsScreen = 3;

// One launch of the tiled plan (ctypes mirror:
// lb2d_tpu_torch/ops/_build.py:FftPass; the two change together; the
// fields are those of lb2d_tpu_torch/ops/spectral.py:FftPass). Rows:
// blocks of `lines` rows of `total`, `in_len` values read and `out_len`
// written per row, rows in_pitch / out_pitch elements apart. Columns:
// tiles of `lines` columns of `total` (the planes' pitch), gridDim.y =
// groups, gridDim.z = planes; element e of group g read from row g in_gmul
// + e in_stride and written to row g out_gmul + e out_stride, times
// W_N^(-+ g e) when tw_group; the screen's ky = g + n1 e.
struct Lb2dFftPass {
  int kind, inverse, n, num_radices;
  int radices[kPassMaxStages];
  int tw_stride, tw_group, lines, total, threads, groups, planes, n1;
  int in_pitch, out_pitch, in_len, out_len;
  int in_gmul, in_stride, out_gmul, out_stride;
  int ny, nx;
  float lam2, out_scale;
};

namespace {

// Shared-memory index of value i of the block: rows padded, columns not
template <bool kCols>
__device__ __forceinline__ int spad(int i) {
  return kCols ? i : i + (i >> 4);
}

// W_N^idx from the table (forward), or its conjugate (inverse)
template <bool kInv>
__device__ __forceinline__ float2 table_w(const float2* __restrict__ tw,
                                          int idx) {
  const float2 w = __ldg(tw + idx);
  return kInv ? make_float2(w.x, -w.y) : w;
}

// W_16^t, forward or inverse
template <bool kInv>
__device__ __forceinline__ float2 w16(int t) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  constexpr float h = 0.70710678118654752f;
  constexpr float c[16] = {1.0f, c1,  h,  s1,  0.0f,  -s1, -h, -c1,
                           -1.0f, -c1, -h, -s1, 0.0f, s1,  h,  c1};
  constexpr float s[16] = {0.0f, s1,  h,  c1,  1.0f,  c1,  h,  s1,
                           0.0f, -s1, -h, -c1, -1.0f, -c1, -h, -s1};
  return make_float2(c[t], kInv ? s[t] : -s[t]);
}

// W_R^t for R = 3, 5, 7, forward or inverse
template <int R, bool kInv>
__device__ __forceinline__ float2 w_odd(int t) {
  float c, s;
  if constexpr (R == 3) {
    constexpr float cs[3] = {1.0f, -0.5f, -0.5f};
    constexpr float sn[3] = {0.0f, 0.86602540378443865f,
                             -0.86602540378443865f};
    c = cs[t];
    s = sn[t];
  } else if constexpr (R == 5) {
    constexpr float cs[5] = {1.0f, 0.30901699437494742f,
                             -0.80901699437494742f, -0.80901699437494742f,
                             0.30901699437494742f};
    constexpr float sn[5] = {0.0f, 0.95105651629515357f,
                             0.58778525229247313f, -0.58778525229247313f,
                             -0.95105651629515357f};
    c = cs[t];
    s = sn[t];
  } else {
    constexpr float cs[7] = {1.0f,
                             0.62348980185873353f,
                             -0.22252093395631440f,
                             -0.90096886790241913f,
                             -0.90096886790241913f,
                             -0.22252093395631440f,
                             0.62348980185873353f};
    constexpr float sn[7] = {0.0f,
                             0.78183148246802981f,
                             0.97492791218182360f,
                             0.43388373911755812f,
                             -0.43388373911755812f,
                             -0.97492791218182360f,
                             -0.78183148246802981f};
    c = cs[t];
    s = sn[t];
  }
  return make_float2(c, kInv ? s : -s);
}

// The R-point DFT of v in registers: 2, 4, 8 as in dft_regs, 16 as 4 x 4
// (x[4 n1 + n2] -> four 4-point DFTs over n1, times W_16^(n2 k1), four
// over n2 -> X[k1 + 4 k2]), 3, 5, 7 as length-R sums.
template <int R, bool kInv>
__device__ __forceinline__ void dft_reg(float2 (&v)[R]) {
  if constexpr (R == 2 || R == 4 || R == 8) {
    dft_regs<R>(v, kInv);
  } else if constexpr (R == 16) {
    float2 t[4][4];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      float2 u[4] = {v[n2], v[4 + n2], v[8 + n2], v[12 + n2]};
      dft4(u[0], u[1], u[2], u[3], kInv);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        t[n2][k1] = n2 * k1 == 0 ? u[k1] : cmul(u[k1], w16<kInv>(n2 * k1));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 u[4] = {t[0][k1], t[1][k1], t[2][k1], t[3][k1]};
      dft4(u[0], u[1], u[2], u[3], kInv);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = u[k2];
    }
  } else {
    float2 out[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = v[0];
#pragma unroll
      for (int m = 1; m < R; ++m)
        acc = cadd(acc, cmul(v[m], w_odd<R, kInv>((m * k) % R)));
      out[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = out[k];
  }
}

// The twiddles w[r] = W^(r t), r = 1 .. R - 1, of a butterfly, t its table
// entry for r = 1, each read from the table; or, radix 16 in the kernels
// with a stage table (kLeft > 0), W_(16 Ns)^(q jm) for q = 1, 2, 4, 8 read
// from the stage's rows of it (stw[row Ns + jm]: neighbouring butterflies
// read neighbouring entries) and the others formed as products of at most
// three of them, a few ulp off the table's roundings.
template <int R, bool kInv>
__device__ __forceinline__ void stage_twiddles(const float2* __restrict__ tw,
                                               int t, float2 (&w)[R]) {
#pragma unroll
  for (int r = 1; r < R; ++r) w[r] = table_w<kInv>(tw, r * t);
}

template <bool kInv>
__device__ __forceinline__ void stage_twiddles16(
    const float2* __restrict__ stw, int Ns, int jm, float2 (&w)[16]) {
  w[1] = table_w<kInv>(stw, jm);
  w[2] = table_w<kInv>(stw, Ns + jm);
  w[4] = table_w<kInv>(stw, 2 * Ns + jm);
  w[8] = table_w<kInv>(stw, 3 * Ns + jm);
  w[3] = cmul(w[1], w[2]);
  w[5] = cmul(w[1], w[4]);
  w[6] = cmul(w[2], w[4]);
  w[7] = cmul(w[3], w[4]);
#pragma unroll
  for (int r = 9; r < 16; ++r) w[r] = cmul(w[r - 8], w[8]);
}

// One in-place Stockham stage of radix R on L lines of n points in the
// buffer: element e of line l at e W + l (kCols, lines adjacent) or l n +
// e (rows). Butterfly j (jm = j mod Ns) of line l takes the values e = j
// + r n / R, times W_(Ns R)^(r jm), from table entry jm (n / (Ns R))
// tw_step (stage_twiddles; kTw: the first stage, Ns = 1, has none), an
// R-point DFT, and puts output
// k at (j - jm) R + jm + k Ns. A thread takes butterflies threadIdx.x + g
// blockDim.x, g < G, holds their values across the barrier and stores
// them after it (recomputing where: a register less per butterfly).
template <int R, int G, bool kInv, bool kCols, bool kTw>
__device__ __forceinline__ void pass_stage(float2* buf, int n, int L, int W,
                                           int Ns,
                                           const float2* __restrict__ tw,
                                           int tw_step,
                                           const float2* __restrict__ stw) {
  const int m = n / R, total = L * m;
  const int es = kCols ? W : 1;
  const auto place = [&](int b, int& j, int& jm) {
    int l;
    if (kCols) {
      j = b / L;
      l = b - j * L;
    } else {
      l = b / m;
      j = b - l * m;
    }
    jm = kTw ? j % Ns : 0;
    return l;
  };
  float2 v[G][R];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = threadIdx.x + g * blockDim.x;
    if (b < total) {
      int j, jm;
      const int l = place(b, j, jm);
      const int in = kCols ? j * W + l : l * n + j;
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[g][r] = buf[spad<kCols>(in + r * m * es)];
      if (kTw && jm != 0) {
        float2 w[R];
        bool staged = false;
        if constexpr (R == 16) {
          if (stw != nullptr) {
            stage_twiddles16<kInv>(stw, Ns, jm, w);
            staged = true;
          }
        }
        if (!staged)
          stage_twiddles<R, kInv>(tw, jm * (n / (Ns * R)) * tw_step, w);
#pragma unroll
        for (int r = 1; r < R; ++r) v[g][r] = cmul(v[g][r], w[r]);
      }
      dft_reg<R, kInv>(v[g]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = threadIdx.x + g * blockDim.x;
    if (b < total) {
      int j, jm;
      const int l = place(b, j, jm);
      const int o = (j - jm) * R + jm;
      const int base = kCols ? o * W + l : l * n + o;
#pragma unroll
      for (int k = 0; k < R; ++k)
        buf[spad<kCols>(base + k * Ns * es)] = v[g][k];
    }
  }
  __syncthreads();
}

// The n-point DFT, in place, of L lines of the buffer, in the stages of
// p.radices. kLeft 1, 2, 4, 8: radix kLeft (if above 1) and then radix 16
// only, the radix-16 twiddles from the stage table st (four rows of Ns
// entries per radix-16 stage, in stage order); kLeft 0: any of 16, 8, 4,
// 2, 3, 5, 7 in any order (G = ceil(kValues / R) butterflies per thread,
// which the host's thread count covers), the twiddles from tw.
template <bool kInv, bool kCols, int kLeft>
__device__ __forceinline__ void fft_block(float2* buf, const Lb2dFftPass& p,
                                          int L, int W,
                                          const float2* __restrict__ tw,
                                          const float2* __restrict__ st) {
  const int n = p.n, s = p.tw_stride;
  int Ns = 1, r0 = 0;
  if constexpr (kLeft > 1) {
    pass_stage<kLeft, kValues / kLeft, kInv, kCols, false>(buf, n, L, W, 1,
                                                           tw, s, nullptr);
    Ns = kLeft;
    r0 = 1;
  }
  if constexpr (kLeft > 0) {
    for (int r = r0; r < p.num_radices; ++r) {
      pass_stage<16, 1, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, st);
      st += 4 * Ns;
      Ns *= 16;
    }
  } else {
    for (int r = 0; r < p.num_radices; ++r) {
      const int R = p.radices[r];
      if (R == 16)
        pass_stage<16, 1, kInv, kCols, true>(buf, n, L, W, Ns, tw, s,
                                             nullptr);
      else if (R == 8)
        pass_stage<8, 2, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      else if (R == 4)
        pass_stage<4, 4, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      else if (R == 2)
        pass_stage<2, 8, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      else if (R == 3)
        pass_stage<3, 6, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      else if (R == 5)
        pass_stage<5, 4, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      else
        pass_stage<7, 3, kInv, kCols, true>(buf, n, L, W, Ns, tw, s, nullptr);
      Ns *= R;
    }
  }
}

// Butterflies per thread of a stage of radix r (fft_block's G)
__host__ __device__ inline int stage_group(int r) {
  return (kValues + r - 1) / r;
}

// f(i) for i = threadIdx.x + v blockDim.x < total, v < kValues (the host's
// thread count covers every i), kBatch at a time: the loads of a batch are
// issued before any of their values is used, so each thread keeps kBatch
// reads of device memory in flight
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
#pragma unroll
  for (int v0 = 0; v0 < kValues; v0 += kBatch) {
    decltype(load(0)) t[kBatch];
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int i = threadIdx.x + (v0 + v) * blockDim.x;
      if (i < total) t[v] = load(i);
    }
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int i = threadIdx.x + (v0 + v) * blockDim.x;
      if (i < total) store(i, t[v]);
    }
  }
}

struct Pair {
  float2 a, b;
};

template <int kKind, int kLeft>
__global__ void __launch_bounds__(kFftMaxThreads)
fft_rows_kernel(const void* __restrict__ in0, const void* __restrict__ in1,
                void* __restrict__ out0, void* __restrict__ out1,
                const float2* __restrict__ tw, const float2* __restrict__ st,
                Lb2dFftPass p) {
  extern __shared__ float2 sbuf[];
  const int n = p.n;
  const int row0 = blockIdx.x * p.lines;
  const int nl = min(p.lines, p.total - row0);
  if constexpr (kKind == kPassRowReal) {
    // line l: rows 2 (row0 + l) and the next (zero past p.ny) as re, im
    const float* rho = static_cast<const float*>(in0);
    batched<8>(
        nl * n,
        [&](int i) {
          const int l = i / n, e = i - l * n;
          const int r = 2 * (row0 + l);
          const float* a = rho + (size_t)r * p.in_pitch + e;
          return make_float2(__ldg(a), r + 1 < p.ny ? __ldg(a + p.in_pitch)
                                                    : 0.0f);
        },
        [&](int i, float2 v) { sbuf[spad<false>(i)] = v; });
  } else {
    const float2* A = static_cast<const float2*>(in0) +
                      (size_t)row0 * p.in_pitch;
    const float2* B = static_cast<const float2*>(in1) +
                      (size_t)row0 * p.in_pitch;
    const int hx = p.in_len;
    batched<8>(
        nl * hx,
        [&](int i) {
          const int l = i / hx, e = i - l * hx;
          const size_t o = (size_t)l * p.in_pitch + e;
          return Pair{__ldg(A + o), __ldg(B + o)};
        },
        [&](int i, Pair v) {
          const int l = i / hx, e = i - l * hx;
          const float2 a = v.a, b = v.b;
          sbuf[spad<false>(l * n + e)] = make_float2(a.x - b.y, a.y + b.x);
          if (e >= 1 && n - e >= hx)
            sbuf[spad<false>(l * n + n - e)] =
                make_float2(a.x + b.y, b.x - a.y);
        });
  }
  __syncthreads();
  fft_block<kKind == kPassRowPack, false, kLeft>(sbuf, p, nl, n, tw, st);
  if constexpr (kKind == kPassRowReal) {
    // the two rows' half spectra by Hermitian symmetry: with Z the line's
    // DFT, X_a[k] = (Z[k] + conj Z[-k]) / 2, X_b[k] = -i (Z[k] - conj
    // Z[-k]) / 2
    float2* X = static_cast<float2*>(out0);
    const int hx = p.out_len;
    for (int i = threadIdx.x; i < nl * hx; i += blockDim.x) {
      const int l = i / hx, e = i - l * hx;
      const int r = 2 * (row0 + l);
      const float2 z1 = sbuf[spad<false>(l * n + e)];
      const float2 z2 = sbuf[spad<false>(l * n + (e == 0 ? 0 : n - e))];
      float2* x = X + (size_t)r * p.out_pitch + e;
      *x = make_float2(0.5f * (z1.x + z2.x), 0.5f * (z1.y - z2.y));
      if (r + 1 < p.ny)
        x[p.out_pitch] =
            make_float2(0.5f * (z1.y + z2.y), 0.5f * (z2.x - z1.x));
    }
  } else {
    float* xg = static_cast<float*>(out0) + (size_t)row0 * p.out_pitch;
    float* yg = static_cast<float*>(out1) + (size_t)row0 * p.out_pitch;
    const float s = p.out_scale;
    for (int i = threadIdx.x; i < nl * n; i += blockDim.x) {
      const int l = i / n, e = i - l * n;
      const float2 v = sbuf[spad<false>(i)];
      const size_t o = (size_t)l * p.out_pitch + e;
      xg[o] = v.x * s;
      yg[o] = v.y * s;
    }
  }
}

// Column tiles, plane blockIdx.z: kScreen the forward DFT of the tile of
// in0, the screen and the inverse DFT of gradient spectrum z (A, z = 0, or
// B); else one DFT of the tile of plane z
template <bool kScreen, int kLeft>
__global__ void __launch_bounds__(kFftMaxThreads)
fft_cols_kernel(const float2* __restrict__ in0,
                const float2* __restrict__ in1, float2* __restrict__ out0,
                float2* __restrict__ out1, const float2* __restrict__ tw,
                const float2* __restrict__ st, Lb2dFftPass p) {
  extern __shared__ float2 sbuf[];
  const int n = p.n, TX = p.lines;
  const int c0 = blockIdx.x * TX, g = blockIdx.y, z = blockIdx.z;
  const size_t pitch = (size_t)p.in_pitch;
  const float2* in = (!kScreen && z ? in1 : in0) + c0;
  batched<kValues>(
      n * TX,
      [&](int i) {
        const int e = i / TX, l = i - e * TX;
        const size_t row = (size_t)g * p.in_gmul + (size_t)e * p.in_stride;
        return __ldg(in + row * pitch + l);
      },
      [&](int i, float2 v) { sbuf[i] = v; });
  __syncthreads();
  bool inv = p.inverse != 0;
  if constexpr (kScreen) {
    fft_block<false, true, kLeft>(sbuf, p, TX, TX, tw, st);
    const int nx = p.nx, ny = p.ny;
    for (int i = threadIdx.x; i < n * TX; i += blockDim.x) {
      const int e = i / TX, l = i - e * TX;
      const int kx = c0 + l, ky = g + p.n1 * e;
      const float fkx = (float)freq(kx, nx), fky = (float)freq(ky, ny);
      const float gx = ((nx & 1) == 0 && kx == nx / 2) ? 0.0f : fkx;
      const float gy = ((ny & 1) == 0 && ky == ny / 2) ? 0.0f : fky;
      const float s = 1.0f / (p.lam2 * (fkx * fkx + fky * fky) + 1.0f);
      const float2 X = sbuf[i];
      const float cr = X.x * s, ci = X.y * s;
      const float a = kTwoPi * (z ? gy : gx);
      sbuf[i] = make_float2(-(ci * a), cr * a);
    }
    __syncthreads();
    fft_block<true, true, kLeft>(sbuf, p, TX, TX, tw, st);
    inv = true;
  } else if (inv) {
    fft_block<true, true, kLeft>(sbuf, p, TX, TX, tw, st);
  } else {
    fft_block<false, true, kLeft>(sbuf, p, TX, TX, tw, st);
  }
  float2* out = (z ? out1 : out0) + c0;
  for (int i = threadIdx.x; i < n * TX; i += blockDim.x) {
    const int e = i / TX, l = i - e * TX;
    float2 v = sbuf[i];
    if (p.tw_group) {
      const float2 w = __ldg(tw + g * e);
      v = cmul(v, inv ? make_float2(w.x, -w.y) : w);
    }
    const size_t row = (size_t)g * p.out_gmul + (size_t)e * p.out_stride;
    out[row * pitch + l] = v;
  }
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFftMaxSmem);
}

template <int kLeft>
cudaError_t opt_in_left() {
  const cudaError_t e[4] = {
      raise_smem_limit(fft_rows_kernel<kPassRowReal, kLeft>),
      raise_smem_limit(fft_rows_kernel<kPassRowPack, kLeft>),
      raise_smem_limit(fft_cols_kernel<false, kLeft>),
      raise_smem_limit(fft_cols_kernel<true, kLeft>)};
  for (const cudaError_t x : e)
    if (x != cudaSuccess) return x;
  return cudaSuccess;
}

// Raise the shared-memory limit of the tiled kernels, once
cudaError_t tiled_kernels_opt_in() {
  static const cudaError_t err = [] {
    const cudaError_t e[5] = {opt_in_left<0>(), opt_in_left<1>(),
                              opt_in_left<2>(), opt_in_left<4>(),
                              opt_in_left<8>()};
    for (const cudaError_t x : e)
      if (x != cudaSuccess) return x;
    return cudaSuccess;
  }();
  return err;
}

template <int kLeft>
void launch_tiled(const Lb2dFftPass& p, dim3 grid, size_t smem,
                  cudaStream_t s, const void* in0, const void* in1,
                  void* out0, void* out1, const float2* table,
                  const float2* st) {
  const auto i0 = static_cast<const float2*>(in0);
  const auto i1 = static_cast<const float2*>(in1);
  const auto o0 = static_cast<float2*>(out0);
  const auto o1 = static_cast<float2*>(out1);
  switch (p.kind) {
    case kPassRowReal:
      fft_rows_kernel<kPassRowReal, kLeft><<<grid, p.threads, smem, s>>>(
          in0, in1, out0, out1, table, st, p);
      break;
    case kPassRowPack:
      fft_rows_kernel<kPassRowPack, kLeft><<<grid, p.threads, smem, s>>>(
          in0, in1, out0, out1, table, st, p);
      break;
    case kPassCols:
      fft_cols_kernel<false, kLeft><<<grid, p.threads, smem, s>>>(
          i0, i1, o0, o1, table, st, p);
      break;
    default:
      fft_cols_kernel<true, kLeft><<<grid, p.threads, smem, s>>>(
          i0, i1, o0, o1, table, st, p);
      break;
  }
}

}  // namespace

// One pass of the tiled plan (see Lb2dFftPass): in0, in1 the planes read,
// out0, out1 those written (unused ones NULL), tw the table of W_N^m
// (float2, m < N), st the pass's stage table (for each radix-16 stage of
// p.radices in order, W_(16 Ns)^(q jm) for q = 1, 2, 4, 8 and jm < Ns,
// four rows of Ns; NULL when p.radices is not a leftover radix and 16s).
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_fft_pass(const void* in0, const void* in1, void* out0,
                             void* out1, const void* tw, const void* st,
                             Lb2dFftPass p, void* stream) {
  const bool rows = p.kind == kPassRowReal || p.kind == kPassRowPack;
  if (p.kind < kPassRowReal || p.kind > kPassColsScreen || p.n < 1 ||
      p.lines < 1 || p.total < 1 || p.threads < 32 ||
      p.threads > kFftMaxThreads || p.threads % 32 != 0 ||
      p.num_radices < 0 || p.num_radices > kPassMaxStages || p.tw_stride < 1)
    return (int)cudaErrorInvalidValue;
  // kLeft: a leftover radix first and then 16s, or 0 (any order)
  int left = p.num_radices > 0 && p.radices[0] != 16 ? p.radices[0] : 1;
  long long prod = 1;
  for (int i = 0; i < p.num_radices; ++i) {
    const int r = p.radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 16)
      return (int)cudaErrorInvalidValue;
    // every butterfly of the stage has a thread
    if ((long long)p.threads * stage_group(r) < (long long)p.lines * p.n / r)
      return (int)cudaErrorInvalidValue;
    if (r != 16 && (i > 0 || r % 2 != 0)) left = 0;
    prod *= r;
  }
  if (prod != p.n) return (int)cudaErrorInvalidValue;
  const long long points = (long long)p.lines * p.n;
  if ((long long)p.threads * kValues < points)  // batched()'s loads
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(points + points / 16 + 1) * sizeof(float2);
  if (smem > (size_t)kFftMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (rows) {
    const long long blocks = ((long long)p.total + p.lines - 1) / p.lines;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)blocks);
  } else {
    if (p.total % p.lines != 0 || p.groups < 1 || p.groups > 65535 ||
        p.planes < 1 || p.planes > 2 || p.in_pitch != p.total ||
        p.out_pitch != p.total ||
        (p.kind == kPassColsScreen && p.planes != 2))
      return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)(p.total / p.lines), (unsigned)p.groups,
                (unsigned)p.planes);
  }
  const cudaError_t err = tiled_kernels_opt_in();
  if (err != cudaSuccess) return (int)err;
  if (left > 0 && st == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* table = static_cast<const float2*>(tw);
  const float2* stage = static_cast<const float2*>(st);
  switch (left) {
    case 1:
      launch_tiled<1>(p, grid, smem, s, in0, in1, out0, out1, table, stage);
      break;
    case 2:
      launch_tiled<2>(p, grid, smem, s, in0, in1, out0, out1, table, stage);
      break;
    case 4:
      launch_tiled<4>(p, grid, smem, s, in0, in1, out0, out1, table, stage);
      break;
    case 8:
      launch_tiled<8>(p, grid, smem, s, in0, in1, out0, out1, table, stage);
      break;
    default:
      launch_tiled<0>(p, grid, smem, s, in0, in1, out0, out1, table, stage);
      break;
  }
  return (int)cudaGetLastError();
}

// sizeof(Lb2dFftPass), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_fft_pass_size() { return (int)sizeof(Lb2dFftPass); }
