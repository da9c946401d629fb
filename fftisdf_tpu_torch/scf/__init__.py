"""KRHF/KUHF on ISDF J/K, one-electron integrals, SCF numerics."""
from fftisdf_tpu_torch.scf.hf import KRHF, KUHF  # noqa: F401
