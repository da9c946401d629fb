"""k-point FFT-ISDF: selection, metric pass and the J/K serve."""
from fftisdf_tpu_torch.isdf.kpoint import FFTISDF  # noqa: F401
