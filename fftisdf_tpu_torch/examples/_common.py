"""What the example drivers share: the device and dtype flags, the SCF
choices they imply, the result lines and their parsing, and the gates
against a recorded run.

The JAX package's scripts take ``--tpu`` (the default backend, float32,
the device-resident loop); the port's take ``--device`` (``cuda`` by
default, ``cpu`` on the host; no fallback: without CUDA and without
``--device cpu`` a driver raises) and ``--dtype`` (``float64`` by default,
``float32`` being what ``--tpu`` chose).  On the card an SCF runs the
device-resident loop whenever it has no level shift; conv_tol is 1e-8 in
float64 and 1e-6 in float32.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from fftisdf_tpu_torch.utils.device import resolve_device

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def add_device_args(p, dtype=True):
    """The two flags that replace the JAX scripts' ``--tpu``: ``--device``
    and, where the driver has a float32 route, ``--dtype``."""
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; raises without CUDA unless "
                        "cpu is asked for")
    if dtype:
        p.add_argument("--dtype", default="float64", choices=sorted(DTYPES),
                       help="float64 (default) or float32 (the JAX "
                            "scripts' --tpu precision)")
    return p


def setup(args):
    """(torch.device, torch dtype) of the parsed flags; raises when CUDA
    is asked for and absent."""
    return (resolve_device(args.device),
            DTYPES[getattr(args, "dtype", "float64")])


def conv_tol(dtype):
    """float32 J/K put ~1e-6 Ha of noise into the energy."""
    return 1e-6 if dtype == torch.float32 else 1e-8


def device_loop(device, level_shift=0.0):
    """The device-resident loop on the card unless a level shift is asked
    for (the device loops refuse one)."""
    return device.type == "cuda" and level_shift == 0.0


def build(df, masks=None):
    """``df.build()``, or on the next of ``masks`` (a list of ``{"m0":
    parent mesh, "mask": point indices}``, consumed in build order): the
    tests hold the port to a recorded run's interpolation points, since
    selection on a symmetric cell meets exact ties that two
    implementations break differently.  The recorded run's parent mesh
    must be the example's own, or for an 'auto' mesh one that selection
    reaches from it by densifying a saturated pool (at most twice, its
    default)."""
    if not masks:
        return df.build()
    from fftisdf_tpu_torch.isdf.kpoint import densify_mesh

    rec = masks.pop(0)
    pools = [tuple(df.m0)]
    if df._m0_auto:
        pools += [densify_mesh(pools[0])]
        pools += [densify_mesh(pools[1])]
    if tuple(rec["m0"]) not in pools:
        raise AssertionError(f"parent mesh {pools[0]}, the recorded run's "
                             f"{tuple(rec['m0'])}")
    df.m0 = tuple(rec["m0"])
    return df.build(mask=rec["mask"])


class Lines:
    """``print`` that keeps what it printed, for :func:`parse`."""

    def __init__(self):
        self.lines = []

    def __call__(self, *parts):
        line = " ".join(str(p) for p in parts)
        print(line, flush=True)
        self.lines.extend(line.splitlines())

    def text(self):
        return "\n".join(self.lines)


def _value(tok):
    if tok in ("True", "False"):
        return tok == "True"
    return float(tok)


def parse(text, patterns):
    """Numbers of a driver's output: for each key of ``patterns``, every
    match of its regular expression (multiline) in order, each capture
    group split on white space into floats (``True``/``False`` into
    bools), flattened into one list."""
    out = {}
    for key, pat in patterns.items():
        vals = []
        for m in re.finditer(pat, text, re.MULTILINE):
            for g in m.groups():
                vals.extend(_value(t) for t in g.replace(",", " ").split())
        out[key] = vals
    return out


def emit(path, rec, out=print):
    """One JSON line to standard output and appended to ``path``."""
    line = json.dumps(rec)
    out(line)
    with open(path, "a") as f:
        f.write(line + "\n")


def gates(mod, argv):
    """An example module's GATES that a run with ``argv`` prints: a key of
    its ``PRINTED_IF`` (``{key: predicate of the parsed flags}``) only
    where the predicate holds."""
    args = mod.build_parser().parse_args(argv)
    when = getattr(mod, "PRINTED_IF", {})
    return {k: g for k, g in mod.GATES.items()
            if k not in when or when[k](args)}


def compare(ours, ref, gates):
    """``[(key, error, limit, passed)]`` for each gated key:
    ``gates[key] = (rel, abs)`` holds max |ours - ref| to max(rel * max
    |ref|, abs).  A key that either side did not print, or printed a
    different number of times, fails.  Printed values carry their last
    digit's rounding, so a relative gate finer than that digit takes two
    of its units as ``abs``."""
    rows = []
    for key, (rel, tol) in gates.items():
        a = np.asarray(ours.get(key, []), dtype=np.float64)
        b = np.asarray(ref.get(key, []), dtype=np.float64)
        if a.size == 0 or a.shape != b.shape:
            rows.append((key, float("inf"), tol, False))
            continue
        err = float(np.abs(a - b).max())
        lim = max(rel * float(np.abs(b).max()), tol)
        rows.append((key, err, lim, err <= lim))
    return rows


def numbers(mod, text):
    """The numbers of a driver module's output: its own ``parse`` where it
    has one (JSON lines), else its RESULTS patterns."""
    if hasattr(mod, "parse"):
        return mod.parse(text)
    return parse(text, mod.RESULTS)
