// The SCF cycle's two fixed-trip loops, each as one single-block kernel.
//
// Replaces no TPU kernel: the JAX package runs both loops under
// jax.lax.fori_loop inside the jitted cycle (fftisdf_tpu/scf/core.py,
// adiis_coeffs and smeared_occ), which XLA compiles into one loop on the
// device.  The port queued them from the host one tensor op at a time:
// ~5k launches for the ADIIS descent and ~1.3k for the two spins'
// bisection each cycle, for a few hundred flops a step.
//
// Bound.  Neither loop has work to speak of: the descent is 400 steps of an
// (m, m) mat-vec on an m = 8 simplex, the bisection 90 steps of one
// exponential per eigenvalue over 2 x 496.  Each step ends in block-wide
// reductions whose results the next step needs, so the time is the
// latency of that dependent chain (shuffles, barriers, exp, division) on
// one SM: ~1 us a descent step in float64 on an H100 (0.40 ms for 400),
// 0.07 ms for the bisection of (2, 8, 62), against 81 and 29 ms for the
// host-queued loops.  The design keeps every step on the device with
// nothing in between: one block, state in registers and shared memory,
// the step count as a loop inside the kernel.
//
// Both kernels keep the operation order of the plain PyTorch loops of
// ops/scf_loops.py (a scalar computed in double and cast to the working
// type where PyTorch casts a Python float), so the two agree to roundoff.
// The reductions are butterfly shuffles whose result every lane holds
// bit-identically, so every thread takes the same branch of the bisection.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SPINS = 2;
constexpr double BIG = 1e30;

struct Targets {
  double t[MAX_SPINS];
};

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
// NaN-propagating, as torch.max / torch.min
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return (a != a || a > b) ? a : b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return (a != a || a < b) ? a : b; }
};

template <typename T, typename Op>
__device__ T warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The reduction of v over the block, returned to every thread.  `scratch`
// holds 32 values; `identity` pads the lanes past the block's warps.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T identity, T* scratch) {
  v = warp_reduce(v, op);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  const int lane = threadIdx.x & 31;
  __syncthreads();                  // the previous reduction's reads are done
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_reduce(lane < warps ? scratch[lane] : identity, op);
}

// core.adiis_coeffs' entropic mirror descent on the simplex, from the
// scaled a (m,), bb = b + b^T (m, m) and the live-slot mask vf (m,) as
// 0/1 values.  One block of 32 * ceil(m / 32) threads, thread i owns c_i
// and reads row i of bb from global memory (through L1) every step.
template <typename T>
__global__ void adiis_descent_kernel(const T* __restrict__ a,
                                     const T* __restrict__ bb,
                                     const T* __restrict__ vf,
                                     T* __restrict__ c_out, int m,
                                     int n_steps, T tiny) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_sh = reinterpret_cast<T*>(smem_raw);      // m
  T* scratch = c_sh + m;                         // 32
  const int i = threadIdx.x;
  const bool live = i < m;
  const T* row = bb + static_cast<size_t>(i) * m;
  const T ai = live ? a[i] : T(0);
  const T vi = live ? vf[i] : T(0);
  // c = vf / vf.sum()
  T ci = vi / block_reduce(vi, Sum(), T(0), scratch);
  for (int t = 0; t < n_steps; ++t) {
    __syncthreads();                // the last step's reads of c_sh are done
    if (live) c_sh[i] = ci;
    __syncthreads();
    // g = (2 a + bb @ c) * vf
    T acc = T(0);
    if (live)
      for (int j = 0; j < m; ++j) acc += row[j] * c_sh[j];
    T gi = (T(2) * ai + acc) * vi;
    // g = g - (c * g).sum()
    gi = gi - block_reduce(ci * gi, Sum(), T(0), scratch);
    // gmax = (|g| * vf).max() + tiny; the padding's 0 is below every |g|
    const T gmax = block_reduce(fabs(gi) * vi, Max(), T(0), scratch) + tiny;
    // c = c * exp(-(2 / (1 + 0.02 t)) * g / gmax) * vf, the step rounded
    // as Python rounds it (no fused multiply-add), then cast
    const T step = static_cast<T>(-(2.0 / __dadd_rn(1.0, __dmul_rn(0.02, t))));
    ci = ci * exp(step * gi / gmax) * vi;
    // c = c / (c.sum() + tiny)
    ci = ci / (block_reduce(ci, Sum(), T(0), scratch) + tiny);
  }
  if (live) c_out[i] = ci;
}

// core.smeared_occ for each spin: block `s` bisects the chemical potential
// of e[s] (n values, ok[s] their 0/1 validity) to the electron count
// targets.t[s] in 90 steps, then writes the occupations f[s], the entropy
// ent[s] and mu[s].  Threads stride over the n values.
template <typename T>
__device__ T occupation(T e, T mu, T sigma, T clip, bool fermi) {
  T x = (e - mu) / sigma;
  x = x < -clip ? -clip : (x > clip ? clip : x);
  return fermi ? T(1) / (T(1) + exp(x)) : T(0.5) * erfc(x);
}

template <typename T>
__device__ T electrons(const T* e, const unsigned char* ok, int n, T mu,
                       T sigma, T clip, bool fermi, T* scratch) {
  T part = T(0);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    part += ok[k] ? occupation(e[k], mu, sigma, clip, fermi) : T(0);
  return block_reduce(part, Sum(), T(0), scratch);
}

template <typename T>
__global__ void smeared_bisect_kernel(const T* __restrict__ e_all,
                                      const unsigned char* __restrict__ ok_all,
                                      int n, Targets targets, double sigma_d,
                                      T clip, int fermi_flag, T f_lo, T f_hi,
                                      T* __restrict__ f_all,
                                      T* __restrict__ ent,
                                      T* __restrict__ mu_out) {
  __shared__ T scratch[32];
  const int s = blockIdx.x;
  const T* e = e_all + static_cast<size_t>(s) * n;
  const unsigned char* ok = ok_all + static_cast<size_t>(s) * n;
  T* f = f_all + static_cast<size_t>(s) * n;
  const bool fermi = fermi_flag != 0;
  const T sigma = static_cast<T>(sigma_d);
  const T target = static_cast<T>(targets.t[s]);
  const T big = static_cast<T>(BIG);
  // lo = where(ok, e, big).min() - 45 sigma; hi likewise from the max
  T emin = big, emax = -big;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const T ek = e[k];
    emin = Min()(emin, ok[k] ? ek : big);
    emax = Max()(emax, ok[k] ? ek : -big);
  }
  const T pad = static_cast<T>(45.0 * sigma_d);
  T lo = block_reduce(emin, Min(), big, scratch) - pad;
  T hi = block_reduce(emax, Max(), -big, scratch) + pad;
  for (int it = 0; it < 90; ++it) {
    const T mu = T(0.5) * (lo + hi);
    const bool below =
        electrons(e, ok, n, mu, sigma, clip, fermi, scratch) < target;
    lo = below ? mu : lo;
    hi = below ? hi : mu;
  }
  const T mu = T(0.5) * (lo + hi);
  const T two_sqrt_pi = static_cast<T>(3.5449077018110318);
  T part = T(0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const T fk = ok[k] ? occupation(e[k], mu, sigma, clip, fermi) : T(0);
    f[k] = fk;
    T sk;
    if (fermi) {
      const T fc = fk < f_lo ? f_lo : (fk > f_hi ? f_hi : fk);
      sk = -(fc * log(fc) + (T(1) - fc) * log1p(-fc));
      sk = (ok[k] && fk > f_lo && fk < f_hi) ? sk : T(0);
    } else {
      const T x = (e[k] - mu) / sigma;
      sk = ok[k] ? exp(-x * x) / two_sqrt_pi : T(0);
    }
    part += sk;
  }
  const T total = block_reduce(part, Sum(), T(0), scratch);
  if (threadIdx.x == 0) {
    ent[s] = total;
    mu_out[s] = mu;
  }
}

template <typename T>
int launch_adiis(const T* a, const T* bb, const T* vf, T* c, int m,
                 int n_steps, double tiny, void* stream) {
  const int threads = 32 * ((m + 31) / 32);
  const size_t smem = sizeof(T) * (m + 32);
  adiis_descent_kernel<T><<<1, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      a, bb, vf, c, m, n_steps, static_cast<T>(tiny));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bisect(const T* e, const unsigned char* ok, int ns, int n,
                  const double* targets, double sigma, double clip, int fermi,
                  double f_lo, double f_hi, T* f, T* ent, T* mu,
                  void* stream) {
  if (ns < 1 || ns > MAX_SPINS) return static_cast<int>(cudaErrorInvalidValue);
  Targets tg{};
  for (int s = 0; s < ns; ++s) tg.t[s] = targets[s];
  int threads = 32 * ((n + 31) / 32);
  if (threads > 1024) threads = 1024;
  smeared_bisect_kernel<T><<<ns, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      e, ok, n, tg, sigma, static_cast<T>(clip), fermi, static_cast<T>(f_lo),
      static_cast<T>(f_hi), f, ent, mu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, vf: (m,), bb: (m, m), c: (m,) out, all contiguous, 1 <= m <= 1024
extern "C" int adiis_descent_d(const double* a, const double* bb,
                               const double* vf, double* c, int m,
                               int n_steps, double tiny, void* stream) {
  return launch_adiis(a, bb, vf, c, m, n_steps, tiny, stream);
}

extern "C" int adiis_descent_f(const float* a, const float* bb,
                               const float* vf, float* c, int m, int n_steps,
                               double tiny, void* stream) {
  return launch_adiis(a, bb, vf, c, m, n_steps, tiny, stream);
}

// e, ok, f: (ns, n) contiguous, ok as bytes; targets: ns host doubles;
// ent, mu: (ns,) out; fermi 1 for Fermi-Dirac, 0 for the Gaussian
extern "C" int smeared_bisect_d(const double* e, const unsigned char* ok,
                                int ns, int n, const double* targets,
                                double sigma, double clip, int fermi,
                                double f_lo, double f_hi, double* f,
                                double* ent, double* mu, void* stream) {
  return launch_bisect(e, ok, ns, n, targets, sigma, clip, fermi, f_lo, f_hi,
                       f, ent, mu, stream);
}

extern "C" int smeared_bisect_f(const float* e, const unsigned char* ok,
                                int ns, int n, const double* targets,
                                double sigma, double clip, int fermi,
                                double f_lo, double f_hi, float* f,
                                float* ent, float* mu, void* stream) {
  return launch_bisect(e, ok, ns, n, targets, sigma, clip, fermi, f_lo, f_hi,
                       f, ent, mu, stream);
}
