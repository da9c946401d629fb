"""Device and dtype policy of the port.

Every constructor and entry point takes ``device``, ``"cuda"`` by default;
a caller passes ``"cpu"`` to run on the host.  :func:`resolve_device`
turns the argument into a ``torch.device`` and raises when CUDA is asked
for and absent: nothing falls back to the CPU on its own.

The port computes in float64 / complex128 unless the caller asks for
``dtype=torch.float32`` (the JAX package's accelerator default): CUDA has
complex128, so no default flips with the device.  :func:`real_complex` is
the one place that maps a build dtype to its real/complex pair.  The JAX
package needs full-precision matmuls (it pins 'highest' everywhere, and its
README records that a lower matmul precision NaNs the fitting solve), so
TF32 stays off in float32 too.
"""
from __future__ import annotations

import torch

_PAIRS = {
    torch.float64: (torch.float64, torch.complex128),
    torch.complex128: (torch.float64, torch.complex128),
    torch.float32: (torch.float32, torch.complex64),
    torch.complex64: (torch.float32, torch.complex64),
}


def real_complex(dtype=None):
    """``(real, complex)`` torch dtypes of a build dtype: float64 and
    complex128 for None or ``torch.float64``, float32 and complex64 for
    ``torch.float32``.  A complex dtype maps to its own pair."""
    if dtype is None:
        return _PAIRS[torch.float64]
    if dtype not in _PAIRS:
        raise ValueError(f"unsupported dtype {dtype}: use torch.float32 or "
                         "torch.float64")
    return _PAIRS[dtype]


def _forbid_tf32():
    # TF32 keeps ~10 mantissa bits.  The pair grams, the ridge Cholesky and
    # the J/K sandwiches are ill-conditioned (cond ~ 1/rcond = 1e10), so a
    # TF32 product anywhere would dominate the fit error.  PyTorch already
    # defaults matmuls to full FP32, but cuDNN defaults to TF32; set both so
    # the policy is stated rather than inherited.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ('cpu', 'cuda', 'cuda:0', a device;
    None means 'cuda').

    Raises ``RuntimeError`` when a CUDA device is requested and CUDA is not
    available: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    _forbid_tf32()
    return dev


def free_memory_bytes(device: torch.device) -> int:
    """Bytes the device can still allocate: ``cudaMemGetInfo`` plus what the
    caching allocator holds but does not use on CUDA, the available
    physical memory on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        reserved = torch.cuda.memory_reserved(device)
        allocated = torch.cuda.memory_allocated(device)
        return int(free + reserved - allocated)
    import os

    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def memory_blocks(n, per_item, device):
    """Slices of ``n`` items (vectors, frequencies, k-points) whose
    temporaries, ``per_item`` bytes an item, fit in a quarter of the
    device's free memory."""
    m = int(max(1, min(n, free_memory_bytes(device)
                       // (4 * max(int(per_item), 1)))))
    return [slice(i, min(n, i + m)) for i in range(0, n, m)]


def as_tensor(x, device, dtype):
    """numpy array / tensor -> tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def to_numpy(x):
    """Tensor (any device) -> numpy array; numpy passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return x
