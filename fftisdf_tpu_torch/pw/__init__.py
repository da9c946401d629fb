"""The exact plane-wave oracle: periodic Poisson solves of Bloch pair
densities, exact J/K at mesh k-points and exact ERIs."""
from fftisdf_tpu_torch.pw.poisson import pair_potential  # noqa: F401
from fftisdf_tpu_torch.pw.eri import (get_ao_pairs_G,  # noqa: F401
                                      get_eri_from_ao)
from fftisdf_tpu_torch.pw.jk import get_jk_kpts  # noqa: F401
