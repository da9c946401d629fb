"""KRHF/KUHF and KRKS/KUKS on ISDF or exact plane-wave J/K (host and
device-resident loops), one-electron integrals, SCF numerics, DFT+U,
population analysis and densities of states."""
from fftisdf_tpu_torch.scf.hf import KRHF, KUHF, PWDF  # noqa: F401
from fftisdf_tpu_torch.scf.device import DeviceKRHF, DeviceKUHF  # noqa: F401
from fftisdf_tpu_torch.scf.ks import (KRKS, KUKS, DeviceKRKS,  # noqa: F401
                                      DeviceKUKS)
