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
// complex64 (c64::pair_gram_f32_kernel) keeps the SIMT design: BK-wide
// chunks of the Re and Im planes staged transposed in shared memory, 4 x 4
// register micro-tiles, plain FP32 FMA (never TF32: the Pallas kernel pins
// HIGHEST precision).
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

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

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int TM = BM / TY;   // 4
constexpr int TN = BN / TX;   // 4

// xr, xi: (ng, kk) row-major real planes
__global__ void __launch_bounds__(TX * TY)
pair_gram_f32_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi, float* __restrict__ out,
                     int ng, int kk, float inv_nk2, int square) {
  // +1 column of padding: the transposed stores of the staging loop hit
  // distinct banks
  __shared__ float a_r[BK][BM + 1];
  __shared__ float a_i[BK][BM + 1];
  __shared__ float b_r[BK][BN + 1];
  __shared__ float b_i[BK][BN + 1];

  const int nt = (ng + BM - 1) / BM;
  int rem = blockIdx.x;
  int ti = 0;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long row0 = static_cast<long>(ti) * BM;
  const long col0 = static_cast<long>(tj) * BN;

  float acc_r[TM][TN];
  float acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = 0.0f;
      acc_i[i][j] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < kk; k0 += BK) {
    // stage BM x BK of the row tile and BN x BK of the column tile,
    // transposed ([k][row]); consecutive threads read consecutive k of a
    // row (BK = 16 contiguous values), out-of-range entries are zero
#pragma unroll
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = e / BK;
      const int cc = e % BK;
      const long gr = row0 + r;
      const long gc = col0 + r;
      const int kc = k0 + cc;
      const bool kin = kc < kk;
      const bool rin = kin && gr < ng;
      const bool cin = kin && gc < ng;
      a_r[cc][r] = rin ? xr[gr * kk + kc] : 0.0f;
      a_i[cc][r] = rin ? xi[gr * kk + kc] : 0.0f;
      b_r[cc][r] = cin ? xr[gc * kk + kc] : 0.0f;
      b_i[cc][r] = cin ? xi[gc * kk + kc] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < BK; ++cc) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = a_r[cc][ty + TY * i];
        ai[i] = a_i[cc][ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = b_r[cc][tx + TX * j];
        bi[j] = b_i[cc][tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(ai[i], bi[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(ar[i], bi[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(-ai[i], br[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gr = row0 + ty + TY * i;
    if (gr >= ng) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long h = col0 + tx + TX * j;
      if (h >= ng) continue;
      float v = (acc_r[i][j] * acc_r[i][j] + acc_i[i][j] * acc_i[i][j])
                * inv_nk2;
      if (square) v = v * v;
      out[gr * ng + h] = v;
      if (ti != tj) out[h * ng + gr] = v;
    }
  }
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

// xr, xi: (ng, kk) row-major float planes
extern "C" int pair_gram_sq_f32(const float* xr, const float* xi,
                                float* out, int ng, int kk, float inv_nk,
                                int square, void* stream) {
  static_assert(c64::BM == c64::BN, "square tiles: the triangle map");
  const long nt = (ng + c64::BM - 1) / c64::BM;
  c64::pair_gram_f32_kernel<<<static_cast<unsigned>(nt * (nt + 1) / 2),
                              c64::TX * c64::TY, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      xr, xi, out, ng, kk, inv_nk * inv_nk, square);
  return static_cast<int>(cudaGetLastError());
}
