"""KRHF/KUHF on ISDF or exact plane-wave J/K (host and device-resident
loops), one-electron integrals, SCF numerics."""
from fftisdf_tpu_torch.scf.hf import KRHF, KUHF, PWDF  # noqa: F401
from fftisdf_tpu_torch.scf.device import DeviceKRHF, DeviceKUHF  # noqa: F401
