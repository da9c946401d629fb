// Squared pair-density gram of interpolation-point selection, for Hopper.
//
// Replaces fftisdf_tpu/ops/pallas_gram.py::pair_gram_sq (Pallas kernel
// body _gram_kernel).  With X (nk, ng, nao) complex and its (k, ao) axes
// flattened into K = nk * nao contraction columns c = k * nao + m:
//
//   G[g,h]   = sum_c conj(X[g,c]) X[h,c]
//            = (xr_g.xr_h + xi_g.xi_h) + i (xr_g.xi_h - xi_g.xr_h)
//   out[g,h] = ((Re G)^2 + (Im G)^2) * inv_nk^2,   squared once more if
//              `square`.
//
// Bound.  The result is symmetric (|G[h,g]| = |conj(G[g,h])|), so only the
// upper triangle is computed: 4 ng (ng + 1) K flops against 16 ng K bytes
// read and 8 ng^2 written.  At the main-path shape (ng 3375, K 1664,
// complex128) that is 7.6e10 flops over 1.8e8 bytes: compute-bound, 1.13 ms
// on the FP64 tensor cores of an H100 SXM (67 TFLOP/s), against 0.054 ms
// for the bytes.  Without tensor cores the ceiling is the 34 TFLOP/s DFMA
// rate, 2.2 ms, which the first design (SIMT DFMA) could not pass.
//
// complex128 design (c128::pair_gram_z_kernel):
// - DMMA: the four real products of the complex gram,
//     Re += Ar Br^T + Ai Bi^T,   Im += Ar Bi^T + (-Ai) Br^T,
//   each an f64 mma.sync (wgmma has no f64 type).  The sign of -Ai is
//   folded into a negated copy of the A fragment; the 3-multiply form is
//   not used, as it changes the roundoff of a quantity whose near-ties
//   decide pivots.  The MMA is m16n8k4: the deeper f64 shapes (k8, k16)
//   keep more fragment registers live beside the 128 of accumulators;
//   they spilled and ran slower on the H100;
// - one block per 64 x 64 tile of the upper triangle, diagonal tiles
//   included; 4 warps, each a 32 x 32 sub-tile (2 x 4 MMA tiles, Re and Im
//   sums: 128 registers of accumulators a thread).  2 blocks share an SM:
//   their 255-register threads fill the register file, and their
//   3 x 32 KB rings fit its shared memory;
// - X is read in place through its strides: each thread keeps the
//   (k-point, AO) pair of its contraction column and advances it by BK per
//   stage, so no permuted copy or real/imag planes are made.  Rows past ng
//   and columns past K are zero-filled by the copy itself.  The loader's
//   row loop stays rolled: unrolled, its hoisted row addresses took the
//   registers the fragments need, and the kernel spilled;
// - a 3-deep ring of 64 x 16 complex tiles in dynamic shared memory,
//   filled by cp.async (16 B, one complex128 each), so the next stages'
//   loads overlap this stage's MMAs.  The 16-B chunk of (row r, column c)
//   sits at r * BK + (c ^ ((r & 1) << 2)): the (re, im) fragment loads of a
//   quarter warp (rows r, r + 1 by 4 columns) hit 8 distinct bank groups;
// - the epilogue takes the modulus (and the optional extra square) into a
//   padded shared tile and writes it twice, row-wise and, for an
//   off-diagonal tile, transposed to the mirrored position: both stores are
//   coalesced, and the padded pitch keeps the transposed reads free of bank
//   conflicts.
//
// complex64 design (c64::pair_gram_c_kernel).  It replaces a SIMT kernel
// (4 x 4 FP32 FMA micro-tiles on copied real/imag planes) that stopped at
// half of the 67 TFLOP/s FP32 rate outside the tensor cores: 16 scalar
// shared loads per 64 FMA kept the load pipe as busy as the FMA pipe.
// The same work on the tensor cores in 3xTF32 is 3 x 4 ng (ng + 1) K flops
// at the 495 TFLOP/s dense TF32 rate: 0.46 ms at (64, 3375, 26), against
// 1.13 ms for FP32 FMA and 0.03 ms for the bytes.  So the bound is the
// tensor cores' rate, and the design keeps them fed:
// - 3xTF32 (CUTLASS's "fast accurate FP32"): every FP32 operand a splits
//   into big = rna_tf32(a) and small = rna_tf32(a - big), and each real
//   product is small.big + big.small + big.big, small terms first, in
//   m16n8k8 TF32 mma.sync with FP32 accumulation.  Single-pass TF32 is not
//   used: it keeps ~11 bits and misses the 2e-5 tolerance of the Pallas
//   kernel, which pins HIGHEST precision; the dropped small.small term is
//   below FP32 roundoff.  The complex product is the four real products of
//   the complex128 design, with -Br (a sign flip of both TF32 halves) in
//   place of -Ai, since B fragments are the transient ones here;
// - the tensor cores' FP32 accumulation truncates.  Chained over all of K
//   its bias grows with K on the all-positive diagonal sums: 6.8x the
//   error of an FP32 GEMM at (3, 100, 7) on the H100, and 5e-5 relative at
//   (64, 200, 26) in an emulation that rounds each MMA toward zero, past
//   the 2e-5 tolerance.  So each k8 step's 6 MMAs of an accumulator start
//   from zero, and the step's partial sum joins the running sum in an
//   IEEE FP32 add (emulated: 2-2.5x the FP32 GEMM's error);
// - fragments are split once, when loaded from shared memory: a warp's A
//   fragments (2 m16 tiles, big and small of Re and Im, 32 registers) stay
//   live over the k8 step and meet each B fragment (8 n8 tiles, loaded,
//   split and used one at a time), 12 MMAs per (A, B) tile pair;
// - one block per 128 x 128 tile of the upper triangle, diagonal tiles
//   included; 8 warps, each a 32 x 64 sub-tile (128 registers of Re and Im
//   accumulators a thread), one block an SM;
// - X is read in place through its strides, as in the complex128 design,
//   into a 4-deep cp.async ring of 128 x 16 complex tiles (32 KB a stage
//   for both operands).  A copy moves 16 B (two AOs of one k-point) where
//   X's AO axis is unit-stride, nao and the other strides are even and X is
//   16-B aligned (contiguous X of even nao: the main path), else 8 B (one
//   complex64); the 16-B copies measured ~5% faster at the main path's
//   shapes on the H100.  Two columns make a 16-B chunk, and the chunk of (row r,
//   column c) sits at r * BK / 2 + ((c / 2) ^ 2 (r % 4)): the 8-B fragment
//   loads of a half warp (4 rows by 4 columns) hit 16 distinct bank pairs;
// - the epilogue is the complex128 design's, in float.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------------------ complex128

namespace c128 {

constexpr int BM = 64;                 // square output tile
constexpr int WARPS_N = 2;
constexpr int THREADS = 128;           // 2 x 2 warps
constexpr int WM = 32;                 // warp sub-tile
constexpr int WN = 32;
constexpr int MI = WM / 16;            // m16 MMA tiles per warp
constexpr int NI = WN / 8;             // n8 MMA tiles per warp
constexpr int BK = 16;                 // contraction columns per stage
constexpr int STAGES = 3;              // cp.async ring length
constexpr int EPI_LD = BM + 1;         // epilogue pitch, doubles
constexpr int SMEM_BYTES = STAGES * 2 * BM * BK * 16;
static_assert(SMEM_BYTES >= BM * EPI_LD * 8,
              "the epilogue tile reuses the ring");
static_assert(BK % 8 == 0, "the swizzle pairs 4-column halves of 8");

// the 16-B chunk of (row r, contraction column c) in a BM x BK stage tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + (c ^ ((r & 1) << 2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;        // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A B for one m16n8k4 f64 tile.  Fragments (g = lane / 4,
// t = lane % 4): a[h] = A[g + 8 h][t], b = B[t][g],
// d[i] = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2],
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// x: (nk, ng, nao) complex128 with element strides sk, sg, sm; out: (ng, ng)
__global__ void __launch_bounds__(THREADS, 2)
pair_gram_z_kernel(const double2* __restrict__ x, long sk, long sg, long sm,
                   int nk, int ng, int nao, double* __restrict__ out,
                   double inv_nk2, int square) {
  extern __shared__ __align__(16) double2 smem[];

  // upper-triangle tile (ti, tj), ti <= tj, of the linear block index
  const int nt = (ng + BM - 1) / BM;
  int rem = blockIdx.x;
  int ti = 0;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const long row0 = static_cast<long>(ti) * BM;
  const long col0 = static_cast<long>(tj) * BM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp / WARPS_N) * WM;
  const int wc = (warp % WARPS_N) * WN;

  // loader: column lj of every stage, rows lr + LROWS i of both tiles;
  // (kq, mq) is the k-point and AO of the column the next stage loads.
  // The row loop is kept rolled: unrolled, its 16 hoisted row addresses
  // cost the registers the MMA fragments need.
  constexpr int LROWS = THREADS / BK;
  static_assert(THREADS % BK == 0 && BM % LROWS == 0 && LROWS % 2 == 0,
                "loader tiling (an even row step keeps the swizzle parity)");
  const int lj = tid % BK;
  const int lr = tid / BK;
  const double2* xa = x + (row0 + lr) * sg;
  const double2* xb = x + (col0 + lr) * sg;
  const long step = LROWS * sg;
  const int va = ng - static_cast<int>(row0) - lr;   // rows left in A, B
  const int vb = ng - static_cast<int>(col0) - lr;
  int kq = lj / nao;
  int mq = lj - kq * nao;
  auto load_stage = [&](int slot) {
    double2* as = smem + slot * 2 * BM * BK + swz(lr, lj);
    double2* bs = as + BM * BK;
    const bool cin = kq < nk;
    const long coff = static_cast<long>(kq) * sk + static_cast<long>(mq) * sm;
    const double2* pa = xa + coff;
    const double2* pb = xb + coff;
#pragma unroll 1
    for (int i = 0; i < BM / LROWS; ++i) {
      const bool ain = cin && LROWS * i < va;
      const bool bin = cin && LROWS * i < vb;
      cp_async16(as + i * LROWS * BK, ain ? pa : x, ain);
      cp_async16(bs + i * LROWS * BK, bin ? pb : x, bin);
      pa += step;
      pb += step;
    }
    mq += BK;
    while (mq >= nao) {
      mq -= nao;
      ++kq;
    }
  };

  double acc_re[MI][NI][4];
  double acc_im[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_re[i][j][e] = 0.0;
        acc_im[i][j][e] = 0.0;
      }

  const int ktiles = (nk * nao + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled here was consumed in iteration kt - 1, which every
    // warp has finished at the barrier above
    if (kt + STAGES - 1 < ktiles) load_stage((kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const double2* as = smem + (kt % STAGES) * 2 * BM * BK;
    const double2* bs = as + BM * BK;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 4) {
      const int c = k0 + t;
      double ar[MI][2], ai[MI][2], nai[MI][2], br[NI], bi[NI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double2 v = as[swz(wr + 16 * i + g + 8 * h, c)];
          ar[i][h] = v.x;
          ai[i][h] = v.y;
          nai[i][h] = -v.y;   // the sign of the Ai Br product
        }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const double2 v = bs[swz(wc + 8 * j + g, c)];
        br[j] = v.x;
        bi[j] = v.y;
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          dmma(acc_re[i][j], ar[i], br[j]);
          dmma(acc_re[i][j], ai[i], bi[j]);
          dmma(acc_im[i][j], ar[i], bi[j]);
          dmma(acc_im[i][j], nai[i], br[j]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: modulus into the shared tile, then row-wise and mirrored
  // coalesced stores
  double* tile = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double re = acc_re[i][j][e];
        const double im = acc_im[i][j][e];
        double v = (re * re + im * im) * inv_nk2;
        if (square) v = v * v;
        tile[(wr + 16 * i + g + 8 * (e >> 1)) * EPI_LD + wc + 8 * j + 2 * t
             + (e & 1)] = v;
      }
  __syncthreads();
  for (int e = tid; e < BM * BM; e += THREADS) {
    const int r = e / BM;
    const int c = e % BM;
    if (row0 + r < ng && col0 + c < ng)
      out[(row0 + r) * ng + col0 + c] = tile[r * EPI_LD + c];
  }
  if (ti != tj) {
    for (int e = tid; e < BM * BM; e += THREADS) {
      const int c = e / BM;
      const int r = e % BM;
      if (row0 + r < ng && col0 + c < ng)
        out[(col0 + c) * ng + row0 + r] = tile[r * EPI_LD + c];
    }
  }
}

}  // namespace c128

// ------------------------------------------------------------- complex64

namespace c64 {

constexpr int BM = 128;                // square output tile
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;       // warp sub-tile, 32 x 64
constexpr int WN = BM / WARPS_N;
constexpr int MI = WM / 16;            // m16 MMA tiles per warp
constexpr int NI = WN / 8;             // n8 MMA tiles per warp
constexpr int BK = 16;                 // contraction columns per stage
constexpr int STAGES = 4;              // cp.async ring length
constexpr int TILE = BM * BK;          // complex values of one operand tile
constexpr int EPI_LD = BM + 1;         // epilogue pitch, floats
constexpr int SMEM_BYTES = STAGES * 2 * TILE * 8;
static_assert(SMEM_BYTES >= BM * EPI_LD * 4,
              "the epilogue tile reuses the ring");
static_assert(BK == 16, "the swizzle permutes the 8 16-B chunks of a row");

// element offset of (row r, contraction column c) in a BM x BK stage tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((((c >> 1) ^ ((r & 3) << 1))) << 1) + (c & 1);
}

// an N-byte cp.async (8 or 16), zero-filling the destination if !valid
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
}

// a = big + small, both TF32 values (round to nearest, ties away)
__device__ __forceinline__ void split(float a, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(a - __uint_as_float(big)));
}

// D += A B for one m16n8k8 TF32 tile.  Fragments (g = lane / 4,
// t = lane % 4): a[h] = A[g + 8 (h % 2)][t + 4 (h / 2)], b[h] = B[t + 4 h][g],
// d[i] = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x: (nk, ng, nao) complex64 with element strides sk, sg, sm; out: (ng, ng).
// PAIRS: each copy moves two adjacent AOs of one k-point (16 B).
template <bool PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
pair_gram_c_kernel(const float2* __restrict__ x, long sk, long sg, long sm,
                   int nk, int ng, int nao, float* __restrict__ out,
                   float inv_nk2, int square) {
  extern __shared__ __align__(16) float2 smem[];

  // upper-triangle tile (ti, tj), ti <= tj, of the linear block index
  const int nt = (ng + BM - 1) / BM;
  int rem = blockIdx.x;
  int ti = 0;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const long row0 = static_cast<long>(ti) * BM;
  const long col0 = static_cast<long>(tj) * BM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp / WARPS_N) * WM;
  const int wc = (warp % WARPS_N) * WN;

  // loader: columns lc (and lc + 1 for PAIRS) of every stage, rows
  // lr + LROWS i of both tiles; (kq, mq) is the k-point and AO of column lc
  // in the next stage to load.  An even nao keeps mq even for PAIRS.
  constexpr int CW = PAIRS ? 2 : 1;
  constexpr int LCOLS = BK / CW;
  constexpr int LROWS = THREADS / LCOLS;
  static_assert(THREADS % LCOLS == 0 && BM % LROWS == 0 && LROWS % 4 == 0,
                "loader tiling (a row step of 4 keeps the swizzle)");
  const int lc = (tid % LCOLS) * CW;
  const int lr = tid / LCOLS;
  const float2* xa = x + (row0 + lr) * sg;
  const float2* xb = x + (col0 + lr) * sg;
  const long step = LROWS * sg;
  const int va = ng - static_cast<int>(row0) - lr;   // rows left in A, B
  const int vb = ng - static_cast<int>(col0) - lr;
  int kq = lc / nao;
  int mq = lc - kq * nao;
  auto load_stage = [&](int slot) {
    float2* as = smem + slot * 2 * TILE + swz(lr, lc);
    float2* bs = as + TILE;
    const bool cin = kq < nk;
    const long coff = static_cast<long>(kq) * sk + static_cast<long>(mq) * sm;
    const float2* pa = xa + coff;
    const float2* pb = xb + coff;
#pragma unroll 1
    for (int i = 0; i < BM / LROWS; ++i) {
      const bool ain = cin && LROWS * i < va;
      const bool bin = cin && LROWS * i < vb;
      cp_async<8 * CW>(as + i * LROWS * BK, ain ? pa : x, ain);
      cp_async<8 * CW>(bs + i * LROWS * BK, bin ? pb : x, bin);
      pa += step;
      pb += step;
    }
    mq += BK;
    while (mq >= nao) {
      mq -= nao;
      ++kq;
    }
  };

  float acc_re[MI][NI][4];
  float acc_im[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_re[i][j][e] = 0.0f;
        acc_im[i][j][e] = 0.0f;
      }

  const int ktiles = (nk * nao + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s);
    c128::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    c128::cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled here was consumed in iteration kt - 1, which every
    // warp has finished at the barrier above
    if (kt + STAGES - 1 < ktiles) load_stage((kt + STAGES - 1) % STAGES);
    c128::cp_async_commit();

    const float2* as = smem + (kt % STAGES) * 2 * TILE;
    const float2* bs = as + TILE;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      unsigned arb[MI][4], ars[MI][4], aib[MI][4], ais[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 v = as[swz(wr + 16 * i + g + 8 * (h & 1),
                                  k0 + t + 4 * (h >> 1))];
          split(v.x, arb[i][h], ars[i][h]);
          split(v.y, aib[i][h], ais[i][h]);
        }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        unsigned brb[2], brs[2], bib[2], bis[2], nbrb[2], nbrs[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = bs[swz(wc + 8 * j + g, k0 + t + 4 * h)];
          split(v.x, brb[h], brs[h]);
          split(v.y, bib[h], bis[h]);
          nbrb[h] = brb[h] ^ 0x80000000u;   // -Br: rna rounding is odd
          nbrs[h] = brs[h] ^ 0x80000000u;
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float re[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // this k8 step's part
          float im[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma(re, ars[i], brb);
          mma(re, arb[i], brs);
          mma(re, ais[i], bib);
          mma(re, aib[i], bis);
          mma(re, arb[i], brb);
          mma(re, aib[i], bib);
          mma(im, ars[i], bib);
          mma(im, arb[i], bis);
          mma(im, ais[i], nbrb);
          mma(im, aib[i], nbrs);
          mma(im, arb[i], bib);
          mma(im, aib[i], nbrb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_re[i][j][e] += re[e];
            acc_im[i][j][e] += im[e];
          }
        }
      }
    }
  }
  c128::cp_async_wait<0>();
  __syncthreads();

  // epilogue: modulus into the shared tile, then row-wise and mirrored
  // coalesced stores
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc_re[i][j][e];
        const float im = acc_im[i][j][e];
        float v = (re * re + im * im) * inv_nk2;
        if (square) v = v * v;
        tile[(wr + 16 * i + g + 8 * (e >> 1)) * EPI_LD + wc + 8 * j + 2 * t
             + (e & 1)] = v;
      }
  __syncthreads();
  for (int e = tid; e < BM * BM; e += THREADS) {
    const int r = e / BM;
    const int c = e % BM;
    if (row0 + r < ng && col0 + c < ng)
      out[(row0 + r) * ng + col0 + c] = tile[r * EPI_LD + c];
  }
  if (ti != tj) {
    for (int e = tid; e < BM * BM; e += THREADS) {
      const int c = e / BM;
      const int r = e % BM;
      if (row0 + r < ng && col0 + c < ng)
        out[(col0 + c) * ng + row0 + r] = tile[r * EPI_LD + c];
    }
  }
}

template <bool PAIRS>
cudaError_t launch(const void* x, long sk, long sg, long sm, int nk, int ng,
                   int nao, float* out, float inv_nk2, int square,
                   cudaStream_t stream) {
  auto kernel = pair_gram_c_kernel<PAIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long nt = (ng + BM - 1) / BM;
  kernel<<<static_cast<unsigned>(nt * (nt + 1) / 2), THREADS, SMEM_BYTES,
           stream>>>(static_cast<const float2*>(x), sk, sg, sm, nk, ng, nao,
                     out, inv_nk2, square);
  return cudaGetLastError();
}

}  // namespace c64

}  // namespace

// x: (nk, ng, nao) complex128, element strides sk, sg, sm, 16-byte aligned
extern "C" int pair_gram_sq_z(const void* x, long sk, long sg, long sm,
                              int nk, int ng, int nao, double* out,
                              double inv_nk, int square, void* stream) {
  using namespace c128;
  cudaError_t err = cudaFuncSetAttribute(
      pair_gram_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pair_gram_z_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long nt = (ng + BM - 1) / BM;
  pair_gram_z_kernel<<<static_cast<unsigned>(nt * (nt + 1) / 2), THREADS,
                       SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(x), sk, sg, sm, nk, ng, nao, out,
      inv_nk * inv_nk, square);
  return static_cast<int>(cudaGetLastError());
}

// x: (nk, ng, nao) complex64, element strides sk, sg, sm, 8-byte aligned
extern "C" int pair_gram_sq_f32(const void* x, long sk, long sg, long sm,
                                int nk, int ng, int nao, float* out,
                                double inv_nk, int square, void* stream) {
  // 16-B copies where every (k, g, even m) pair starts 16-B aligned
  const bool pairs = sm == 1 && nao % 2 == 0 && sg % 2 == 0 && sk % 2 == 0
                     && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const float inv_nk2 = static_cast<float>(inv_nk * inv_nk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pairs ? c64::launch<true>(x, sk, sg, sm, nk, ng, nao, out, inv_nk2,
                                square, s)
            : c64::launch<false>(x, sk, sg, sm, nk, ng, nao, out, inv_nk2,
                                 square, s);
  return static_cast<int>(err);
}
