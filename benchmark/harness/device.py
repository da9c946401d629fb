"""The card: the check that it is there, its name and power limit, clock
samples beside the window, and the guard that the run loaded no JAX."""
from __future__ import annotations

import subprocess
import sys

import torch

# top-level module names that no run may load (compared whole: the port,
# ``fftisdf_tpu_torch``, is another top-level name than ``fftisdf_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fftisdf_tpu")


class NoCard(RuntimeError):
    """The run asks for more CUDA devices than this machine has."""


def require_cards(n):
    """The first CUDA device, or :class:`NoCard`: a measurement never falls
    back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the card and does not run on the CPU")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} CUDA device(s), this machine has "
                     f"{have}")
    return torch.device("cuda", 0)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def smi(query):
    """One nvidia-smi reading of ``query`` (csv, no header) or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def describe(device, count):
    """The result line's ``device`` without its readings."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": int(count)}
