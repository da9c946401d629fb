// Native host-side lattice engine of fftisdf_tpu_torch.
//
// A copy of the JAX package's native/lattice_engine.cpp, limited to the
// two entry points the port calls; the arithmetic is the same, line for
// line.  The device owns the numerics (PyTorch/CUDA); this library owns
// scalar-heavy host-side setup work:
//   - lattice-image enumeration for Gaussian decay radii (the image lists
//     drive the AO evaluator's scan length),
//   - the real-space part of the Ewald ion-ion energy.
// Python fallbacks exist for every entry point (fftisdf_tpu_torch/native).
//
// Build: g++ -O3 -shared -fPIC lattice_engine.cpp -o liblattice_engine.so

#include <cmath>
#include <cstdint>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 matvec(const double* a /*row-major 3x3*/, double i, double j,
                   double k) {
  // (i, j, k) @ a  with a's rows the lattice vectors
  return {i * a[0] + j * a[3] + k * a[6],
          i * a[1] + j * a[4] + k * a[7],
          i * a[2] + j * a[5] + k * a[8]};
}

}  // namespace

extern "C" {

// Enumerate lattice translations T = (i,j,k) @ a with
// |center + T - cell_center| <= reach.  Returns the count; writes up to
// max_out translations into out (row-major (n,3)).  nmax gives the integer
// search ranges per axis (precomputed by the caller from lattice heights).
int64_t enumerate_images(const double* a, const double* center,
                         const double* cell_center, double reach,
                         const int64_t* nmax, double* out, int64_t max_out) {
  int64_t count = 0;
  const double dx = center[0] - cell_center[0];
  const double dy = center[1] - cell_center[1];
  const double dz = center[2] - cell_center[2];
  for (int64_t i = -nmax[0]; i <= nmax[0]; ++i) {
    for (int64_t j = -nmax[1]; j <= nmax[1]; ++j) {
      for (int64_t k = -nmax[2]; k <= nmax[2]; ++k) {
        Vec3 t = matvec(a, (double)i, (double)j, (double)k);
        const double px = dx + t.x, py = dy + t.y, pz = dz + t.z;
        if (std::sqrt(px * px + py * py + pz * pz) <= reach) {
          if (count < max_out) {
            out[3 * count + 0] = t.x;
            out[3 * count + 1] = t.y;
            out[3 * count + 2] = t.z;
          }
          ++count;
        }
      }
    }
  }
  return count;
}


// Real-space Ewald sum: 0.5 sum_{T, A, B}' Z_A Z_B erfc(sqrt(eta) r)/r
// (self pair A==B at T==0 excluded).  ts: (nt, 3) translations incl. 0.
double ewald_real(const double* coords, const double* charges, int64_t natm,
                  const double* ts, int64_t nt, double eta) {
  const double se = std::sqrt(eta);
  double acc = 0.0;
  for (int64_t t = 0; t < nt; ++t) {
    const double tx = ts[3 * t], ty = ts[3 * t + 1], tz = ts[3 * t + 2];
    const bool origin =
        std::abs(tx) < 1e-12 && std::abs(ty) < 1e-12 && std::abs(tz) < 1e-12;
    for (int64_t aI = 0; aI < natm; ++aI) {
      for (int64_t b = 0; b < natm; ++b) {
        if (origin && aI == b) continue;
        const double rx = coords[3 * aI] - coords[3 * b] + tx;
        const double ry = coords[3 * aI + 1] - coords[3 * b + 1] + ty;
        const double rz = coords[3 * aI + 2] - coords[3 * b + 2] + tz;
        const double r = std::sqrt(rx * rx + ry * ry + rz * rz);
        if (r < 1e-12) continue;
        acc += 0.5 * charges[aI] * charges[b] * std::erfc(se * r) / r;
      }
    }
  }
  return acc;
}

}  // extern "C"
