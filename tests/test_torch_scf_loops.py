"""The SCF cycle's fixed-trip loops (``ops.scf_loops``): the ADIIS mirror
descent and the chemical-potential bisection.

On the CPU the wrappers, and ``scf.core``'s ``adiis_coeffs`` and
``smeared_occ`` through them, take the plain versions, to the bit; the
JAX records of ``test_torch_scf.py`` and ``test_torch_scf_device.py`` hold
those to the reference.  The wrappers check their inputs before the
library loads, so the refusals need no ``nvcc``.

The tests marked ``gpu`` import no JAX and run on the GPU machine:

    python -m pytest tests/test_torch_scf_loops.py -m gpu -q --noconftest

Each kernel is held to its plain version at the benchmark cell's shapes
(m = 8; (2, 8, 62)) and at the 4x4x4 production shape (2, 64, 62): 1e-12
in float64 and 1e-5 in float32, the entropy relative to its size: it sums
every state, and float32 resolves the electron count (~2000 at (2, 64,
62)) only to its ulp, 1.2e-4, so mu to that over dN/dmu and the entropy
to dS/dmu times that.  DeviceKUHF on the card lands on the same
loop's CPU energy to 1e-10 Ha in as many cycles, with one ADIIS launch per
``scf.adiis`` span and one bisection launch per cycle.
"""
import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.ops import scf_loops
from fftisdf_tpu_torch.scf import core
from fftisdf_tpu_torch.utils import profiling

DTYPES = [torch.float64, torch.float32]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


# ------------------------------------------------------------- inputs
def _history(m, dtype, seed=0, length=40):
    """(dms, focks, valid) of an m-slot ring; slot 1 is dead when m > 2."""
    rng = np.random.default_rng(seed + m)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    c = lambda: torch.from_numpy(rng.standard_normal((m, length))
                                 + 1j * rng.standard_normal((m, length))
                                 ).to(cdt)
    valid = torch.ones(m, dtype=torch.bool)
    if m > 2:
        valid[1] = False
    return c(), c(), valid


def _descent_inputs(m, dtype, device="cpu"):
    """The scaled (a, bb, vf) that ``core.adiis_coeffs`` hands the
    descent."""
    dms, focks, valid = _history(m, dtype)
    return tuple(x.to(device) for x in core.adiis_model(dms, focks, m - 1,
                                                        valid))


def _spectrum(shape, dtype, seed=3):
    """Sorted eigenvalues of (ns, nk, nmo) with the last two slots of one
    k row penalised (invalid, far above the spectrum)."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.standard_normal(shape), axis=-1)
    ok = np.ones(shape, dtype=bool)
    ok[:, 1, -2:] = False
    e[:, 1, -2:] = 1e6
    return torch.from_numpy(e).to(dtype), torch.from_numpy(ok)


def _targets(ok):
    """Half the valid slots of each spin, one electron fewer in spin 1."""
    n = ok.flatten(1).sum(1) // 2
    return [float(n[0]), float(n[-1] - 1)]


# ------------------------------------------------------------ CPU tests
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", range(1, 9))
def test_adiis_coeffs_is_the_plain_descent(m, dtype):
    dms, focks, valid = _history(m, dtype)
    c = core.adiis_coeffs(dms, focks, m - 1, valid)
    ref = scf_loops.adiis_descent_reference(
        *core.adiis_model(dms, focks, m - 1, valid))
    assert torch.equal(c, ref)
    assert c.dtype == dtype
    assert (c[~valid] == 0).all()               # dead slots stay absorbing
    assert abs(float(c.sum()) - 1.0) < 10 * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["fermi", "gauss"])
def test_smeared_occ_is_the_plain_bisection(method, dtype):
    e, ok = _spectrum((2, 8, 62), dtype)
    targets = _targets(ok)
    ref = scf_loops.smeared_bisect_reference(e, ok, targets, 5e-3, method)
    got = scf_loops.smeared_bisect(e, ok, targets, 5e-3, method)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    for s in range(2):
        one = core.smeared_occ(e[s], ok[s], targets[s], 5e-3, method)
        for x, y in zip(one, ref):
            assert torch.equal(x, y[s])
        assert (ref[0][s][~ok[s]] == 0).all()
        assert abs(float(ref[0][s].sum()) - targets[s]) < 1e-3


def _adiis_args(**kw):
    a = torch.zeros(kw.pop("m", 4), dtype=kw.pop("dtype", torch.float64))
    args = dict(a=a, bb=torch.zeros(a.shape * 2, dtype=a.dtype),
                vf=torch.ones_like(a))
    args.update(kw)
    return args


def _bisect_args(**kw):
    e, ok = _spectrum((2, 3, 5), torch.float64)
    args = dict(e=e, ok=ok, targets=[4.0, 3.0], sigma=5e-3, method="fermi")
    args.update(kw)
    return args


REFUSED = {
    "adiis int dtype": (scf_loops.adiis_descent,
                        _adiis_args(dtype=torch.int64), TypeError),
    "adiis complex dtype": (scf_loops.adiis_descent,
                            _adiis_args(dtype=torch.complex128), TypeError),
    "adiis mixed dtypes": (scf_loops.adiis_descent,
                           _adiis_args(vf=torch.ones(4, dtype=torch.float32)),
                           TypeError),
    "adiis bb not (m, m)": (scf_loops.adiis_descent,
                            _adiis_args(bb=torch.zeros(4, 5,
                                                       dtype=torch.float64)),
                            ValueError),
    "adiis vf not (m,)": (scf_loops.adiis_descent,
                          _adiis_args(vf=torch.ones(5, dtype=torch.float64)),
                          ValueError),
    "adiis m > 1024": (scf_loops.adiis_descent, _adiis_args(m=1025),
                       ValueError),
    "bisect int dtype": (scf_loops.smeared_bisect,
                         _bisect_args(e=torch.zeros(2, 3, 5,
                                                    dtype=torch.int64)),
                         TypeError),
    "bisect ok shape": (scf_loops.smeared_bisect,
                        _bisect_args(ok=torch.ones(2, 3, 4, dtype=bool)),
                        ValueError),
    "bisect ok not bool": (scf_loops.smeared_bisect,
                           _bisect_args(ok=torch.ones(2, 3, 5)), ValueError),
    "bisect 3 spins": (scf_loops.smeared_bisect,
                       _bisect_args(e=torch.zeros(3, 3, 5,
                                                  dtype=torch.float64),
                                    ok=torch.ones(3, 3, 5, dtype=bool),
                                    targets=[1.0, 1.0, 1.0]), ValueError),
    "bisect targets": (scf_loops.smeared_bisect,
                       _bisect_args(targets=[4.0]), ValueError),
    "bisect sigma 0": (scf_loops.smeared_bisect, _bisect_args(sigma=0.0),
                       ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    fn, args, err = REFUSED[case]
    with pytest.raises(err):
        fn(**args)


def test_no_launch_on_the_cpu():
    before = (scf_loops.adiis_descent.launches,
              scf_loops.smeared_bisect.launches)
    with profiling.recording("cpu"):
        scf_loops.adiis_descent(*_descent_inputs(4, torch.float64))
        scf_loops.smeared_bisect(**_bisect_args())
        counts = profiling.drain()["counts"]
    assert (scf_loops.adiis_descent.launches,
            scf_loops.smeared_bisect.launches) == before
    assert not {"ops.adiis_descent", "ops.smeared_bisect"} & set(counts)


# ------------------------------------------------------------ card tests
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_adiis_kernel_matches_plain(cuda, dtype):
    a, bb, vf = _descent_inputs(8, dtype, cuda)
    before = scf_loops.adiis_descent.launches
    c = scf_loops.adiis_descent(a, bb, vf)
    torch.cuda.synchronize()
    assert scf_loops.adiis_descent.launches == before + 1
    ref = scf_loops.adiis_descent_reference(a, bb, vf)
    assert float((c - ref).abs().max()) <= TOL[dtype]
    assert (c[vf == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["fermi", "gauss"])
@pytest.mark.parametrize("shape", [(2, 8, 62), (2, 64, 62)])
def test_bisection_kernel_matches_plain(cuda, shape, method, dtype):
    e, ok = _spectrum(shape, dtype)
    e, ok = e.to(cuda), ok.to(cuda)
    targets = _targets(ok)
    before = scf_loops.smeared_bisect.launches
    out = scf_loops.smeared_bisect(e, ok, targets, 5e-3, method)
    torch.cuda.synchronize()
    assert scf_loops.smeared_bisect.launches == before + 1
    ref = scf_loops.smeared_bisect_reference(e, ok, targets, 5e-3, method)
    # the entropy sums every state: held relative to its size
    scales = (1.0, max(1.0, float(ref[1].abs().max())), 1.0)
    for name, x, y, scale in zip(("f", "entropy", "mu"), out, ref, scales):
        assert float((x - y).abs().max()) <= TOL[dtype] * scale, name
    assert (out[0][~ok] == 0).all()


@pytest.mark.gpu
def test_device_kuhf_on_cuda_launches_the_loops(cuda):
    """DeviceKUHF (AFM bias, smearing) on the card against the same loop on
    the CPU: the energy to 1e-10 Ha, equal cycles; one ADIIS launch per
    ``scf.adiis`` span and one bisection launch per cycle."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import DeviceKUHF

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=60, smearing=5e-3,
              init_spin={0: +1.0, 1: -1.0})
    runs, mask = {}, None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        mf = DeviceKUHF(cell, kpts, df, device=dev, **kw)
        before = (scf_loops.adiis_descent.launches,
                  scf_loops.smeared_bisect.launches)
        with profiling.recording(dev):
            mf.kernel()
            rec = profiling.drain()
        launches = (scf_loops.adiis_descent.launches - before[0],
                    scf_loops.smeared_bisect.launches - before[1])
        spans = sum(s["name"] == "scf.adiis" for s in rec["spans"])
        runs[str(dev)] = (mf, launches, spans, rec["counts"])
        assert mf.converged
    mf_c, launches_c, _, _ = runs["cpu"]
    mf_g, launches_g, spans, counts = runs[str(cuda)]
    assert launches_c == (0, 0)
    assert abs(mf_g.e_tot - mf_c.e_tot) <= 1e-10
    assert mf_g.cycles == mf_c.cycles
    assert spans > 0
    assert launches_g == (spans, mf_g.cycles)
    assert counts.get("ops.adiis_descent") == spans
    assert counts.get("ops.smeared_bisect") == mf_g.cycles
