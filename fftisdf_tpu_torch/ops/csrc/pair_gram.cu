// Squared pair-density gram of interpolation-point selection, for Hopper.
//
// Replaces fftisdf_tpu/ops/pallas_gram.py::pair_gram_sq (Pallas kernel
// body _gram_kernel).  With X (nk, ng, nao) complex and its (k, ao) axes
// flattened into K = nk * nao columns, split into real planes xr, xi
// (ng, K) row-major:
//
//   G[g,h]   = sum_c conj(X[g,c]) X[h,c]
//            = (xr_g.xr_h + xi_g.xi_h) + i (xr_g.xi_h - xi_g.xr_h)
//   out[g,h] = ((Re G)^2 + (Im G)^2) * inv_nk^2,   squared once more if
//              `square`.
//
// Bound: 8 ng^2 K flops against (2 ng K + ng^2) * sizeof(T) bytes.  At the
// main-path shape (ng 3375, K 1664, double) that is 1.5e11 flops over
// 1.8e8 bytes, ~800 flops per byte: compute-bound on FP64.  The design
// therefore keeps operands in shared memory and accumulates in registers:
//
// - one block per BM x BN output tile of the upper triangle (the result is
//   symmetric: |G[h,g]| = |conj(G[g,h])|), which halves the work; an
//   off-diagonal tile is also stored mirrored;
// - each block loops over K in BK-wide chunks of the Re and Im planes of
//   its row tile and its column tile, staged transposed in shared memory
//   (the TPU kernel carried the K sum across grid steps in VMEM scratch;
//   here the K loop lives inside the block);
// - each of the 16 x 16 threads keeps a TM x TN micro-tile of the Re and Im
//   partial sums in registers, with rows ty + 16 i and columns tx + 16 j so
//   that a warp reads consecutive shared-memory words;
// - the epilogue takes the modulus (and the optional extra square) and
//   stores the real result with the ragged edge masked.
//
// float accumulates with plain FP32 FMA (never TF32: the Pallas kernel pins
// HIGHEST precision); double uses DFMA.  Tensor cores (DMMA) and a
// multi-stage cp.async/TMA pipeline are left for later work.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int TM = BM / TY;   // 4
constexpr int TN = BN / TX;   // 4

template <typename T>
__global__ void __launch_bounds__(TX * TY)
pair_gram_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ out, int ng, int kk, T inv_nk2,
                 int square) {
  // +1 column of padding: the transposed stores of the staging loop hit
  // distinct banks
  __shared__ T a_r[BK][BM + 1];
  __shared__ T a_i[BK][BM + 1];
  __shared__ T b_r[BK][BN + 1];
  __shared__ T b_i[BK][BN + 1];

  // upper-triangle tile (ti, tj), ti <= tj, of the linear block index
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

  T acc_r[TM][TN];
  T acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = T(0);
      acc_i[i][j] = T(0);
    }
  }

  for (int k0 = 0; k0 < kk; k0 += BK) {
    // stage BM x BK of the row tile and BN x BK of the column tile,
    // transposed ([k][row]); consecutive threads read consecutive k of a
    // row (BK = 16 contiguous values), out-of-range entries are zero
#pragma unroll
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = e / BK;
      const int c = e % BK;
      const long gr = row0 + r;
      const long gc = col0 + r;
      const int kc = k0 + c;
      const bool kin = kc < kk;
      const bool rin = kin && gr < ng;
      const bool cin = kin && gc < ng;
      a_r[c][r] = rin ? xr[gr * kk + kc] : T(0);
      a_i[c][r] = rin ? xi[gr * kk + kc] : T(0);
      b_r[c][r] = cin ? xr[gc * kk + kc] : T(0);
      b_i[c][r] = cin ? xi[gc * kk + kc] : T(0);
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < BK; ++c) {
      T ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = a_r[c][ty + TY * i];
        ai[i] = a_i[c][ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = b_r[c][tx + TX * j];
        bi[j] = b_i[c][tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fma(ar[i], br[j], acc_r[i][j]);
          acc_r[i][j] = fma(ai[i], bi[j], acc_r[i][j]);
          acc_i[i][j] = fma(ar[i], bi[j], acc_i[i][j]);
          acc_i[i][j] = fma(-ai[i], br[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long g = row0 + ty + TY * i;
    if (g >= ng) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long h = col0 + tx + TX * j;
      if (h >= ng) continue;
      T v = (acc_r[i][j] * acc_r[i][j] + acc_i[i][j] * acc_i[i][j])
            * inv_nk2;
      if (square) v = v * v;
      out[g * ng + h] = v;
      if (ti != tj) out[h * ng + g] = v;
    }
  }
}

template <typename T>
int launch(const T* xr, const T* xi, T* out, int ng, int kk, T inv_nk,
           int square, void* stream) {
  static_assert(BM == BN, "square tiles: the triangle map assumes them");
  const long nt = (ng + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(nt * (nt + 1) / 2));
  const dim3 block(TX * TY);
  pair_gram_kernel<T><<<grid, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xr, xi, out, ng, kk, inv_nk * inv_nk, square);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pair_gram_sq_f64(const double* xr, const double* xi,
                                double* out, int ng, int kk, double inv_nk,
                                int square, void* stream) {
  return launch<double>(xr, xi, out, ng, kk, inv_nk, square, stream);
}

extern "C" int pair_gram_sq_f32(const float* xr, const float* xi,
                                float* out, int ng, int kk, float inv_nk,
                                int square, void* stream) {
  return launch<float>(xr, xi, out, ng, kk, inv_nk, square, stream);
}
