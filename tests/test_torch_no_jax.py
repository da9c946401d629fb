"""The PyTorch port imports and runs in a process where neither JAX nor
the JAX package can be imported (the GPU machine has no JAX, and the port
keeps its own copy of every host module it needs): with a
``sys.meta_path`` finder that refuses ``jax``, ``jaxlib`` and
``fftisdf_tpu`` (exactly that package, not ``fftisdf_tpu_torch``), every
module of the port imports (the KS, many-body, correlated and derivative
modules among them, the tool layer: ``utils.config``,
``utils.profiling``, ``utils.cube``, ``basis.atom`` and ``basis.fit``, and
the entry points of ``examples``),
one tiny build with ``profile_build``, ``get_jk``, an ISDF force, the
density on the grid and xc evaluation run on a small He2 cell on the CPU,
a CP2K basis entry is parsed, and one ``kmp2`` runs on the H2 chain of
tests/test_mp2.py; none of the refused modules may reach
``sys.modules``."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib
    import pkgutil
    import sys

    BLOCKED = ("jax", "jaxlib", "fftisdf_tpu")

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked: {name}")
            return None

    for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
        del sys.modules[mod]
    sys.meta_path.insert(0, BlockJax())

    # the entry points: every JAX example script but multichip_aot
    EXAMPLES = ("nio_afm_kuhf", "nio_northstar", "diamond_isdf",
                "diamond_ks", "diamond_bands", "molecule_in_a_box",
                "thc_demo", "exciton_dispersion", "cc_spectroscopy",
                "dmet_demo", "relax_vibrations", "lih_variable_cell",
                "phonon_elastic", "derive_atomic_basis")

    import fftisdf_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        fftisdf_tpu_torch.__path__, "fftisdf_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for name in ("isdf.bands", "isdf.cderi", "isdf.gamma", "isdf.ao2mo",
                 "isdf.thc", "lattice.becke", "scf.xc", "scf.ks",
                 "scf.hubbard", "scf.dos", "scf.mp2", "scf.rpa", "scf.gw",
                 "scf.tddft", "scf.bse", "scf.fci", "scf.dmet", "scf.cc",
                 "isdf.autodiff", "scf.grad", "scf.stress", "scf.optimize",
                 "scf.hessian", "scf.md", "scf.phonon", "scf.elastic",
                 "scf.eos", "utils.config", "utils.profiling", "utils.cube",
                 "basis.atom", "basis.fit", "examples._common",
                 *("examples." + ex for ex in EXAMPLES)):
        assert "fftisdf_tpu_torch." + name in names, name

    import numpy as np
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.isdf import FFTISDF

    cell = Cell(a=np.diag([5.0, 5.0, 7.0]),
                atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                basis="sto-3g", pseudo=None, mesh=np.array([9, 9, 11]),
                unit="bohr", precision=1e-10).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0,
                 profile_build=True, device="cpu").build()
    vj, vk = df.get_jk(np.stack([np.eye(2, dtype=complex)] * 2))
    assert vj.shape == (2, 2, 2) and bool(vk.isfinite().all())
    assert list(df._stage_s) == ["factors", "sweep", "spectral", "gram"]
    assert all(v > 0 for v in df._stage_s.values())
    from fftisdf_tpu_torch.basis import data
    assert data.parse_cp2k_basis("He X\\n 1\\n 1 0 0 1 1\\n 1.0 1.0\\n")

    # the derivative layer: the ISDF force of one KRHF on that build
    from fftisdf_tpu_torch.scf import KRHF as _KRHF
    from fftisdf_tpu_torch.scf import grad

    mf = _KRHF(cell, kpts, df, verbose=0, conv_tol=1e-9, device="cpu")
    mf.kernel()
    g, val = grad.kernel(mf, two_electron="isdf", df=df)
    assert g.shape == (2, 3) and abs(val - mf.e_tot) < 1e-8
    from fftisdf_tpu_torch.utils import cube
    rho = cube.density_on_grid(mf)
    assert abs(rho.sum() * cell.vol / rho.size - cell.nelectron) < 1e-8

    import torch
    from fftisdf_tpu_torch.scf import KRKS, KUKS, DeviceKRKS, DeviceKUKS
    from fftisdf_tpu_torch.scf import xc

    fmesh = tuple(int(m) for m in cell.mesh)
    gv = torch.as_tensor(cell.get_Gv(fmesh))
    rho = torch.full((2, int(np.prod(fmesh))), 0.1, dtype=torch.float64)
    exc, v = xc.exc_and_vxc(rho, gv, xc.parse_xc("pbe"), fmesh, 0.01)
    assert bool(torch.isfinite(v).all()) and float(exc) < 0.0

    # the many-body layer: one kmp2 on the H2 chain of tests/test_mp2.py
    from fftisdf_tpu_torch.lattice.cell import Shell
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.mp2 import kmp2

    h2 = Cell(a=np.diag([6.0, 6.0, 7.0]),
              atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
              basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                                 coeffs=np.eye(2))]},
              pseudo="gth-pade", mesh=np.array([14, 14, 17]), unit="bohr",
              precision=1e-12).build()
    kpts = np.zeros((1, 3))
    df = FFTISDF(h2, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                 select_tol=1e-18, rcond=1e-12, device="cpu").build()
    mf = KRHF(h2, kpts, df, verbose=0, conv_tol=1e-10, device="cpu")
    mf.kernel()
    e2, info = kmp2(df, mf)
    assert mf.converged and e2 < 0.0 and abs(info["imag"]) < 1e-10
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    assert "fftisdf_tpu_torch.native" in sys.modules
    print("OK", len(names))
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # two threads, as torch_test_threads gives the port's other tests: the
    # suite's xdist workers share the machine's cores
    env.update(OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")


PARALLEL_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "fftisdf_tpu")

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked: {name}")
            return None

    for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
        del sys.modules[mod]
    sys.meta_path.insert(0, BlockJax())

    import fftisdf_tpu_torch.parallel
    import fftisdf_tpu_torch.parallel.dryrun
    from fftisdf_tpu_torch.parallel import (build_sharded, get_jk_sharded,
                                            make_device_mesh)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("OK")
""")


def test_parallel_imports_without_jax():
    """The mesh layer and its dry run import in a fresh interpreter in
    which JAX and the JAX package cannot be imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"


def test_device_mesh_needs_a_card(monkeypatch):
    """make_device_mesh() defaults to CUDA with NCCL: without a card and
    without device= it raises, and it makes no process group on the CPU
    in its place."""
    import pytest
    import torch
    import torch.distributed as dist

    from fftisdf_tpu_torch.parallel import make_device_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_device_mesh()
    with pytest.raises(ValueError, match="nccl"):
        make_device_mesh(backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_rank_launcher_needs_a_card(monkeypatch):
    """The rank launcher (parallel.dryrun.spawn) has make_device_mesh's
    defaults: without a card and without device= it raises before it
    starts a rank."""
    import pytest
    import torch

    from fftisdf_tpu_torch.parallel import dryrun

    def no_ranks(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.multiprocessing, "get_context", no_ranks)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.spawn(lambda mesh: None, 2)
    with pytest.raises(ValueError, match="nccl"):
        dryrun.spawn(lambda mesh: None, 2, backend="nccl", device="cpu")
