"""The port's tool layer against the JAX package (CPU, f64): the run
configuration (``utils.config``), the profiling hooks
(``utils.profiling``: a span's log line and a trace), the build's stage
attribution (``FFTISDF(profile_build=True)``) and the cube export
(``utils.cube``).  The span recorder itself is held in
tests/test_torch_profiling.py.

Tolerances: the config round trip and ``write_cube``'s text are exact
(byte-equal to the JAX package's); the stage keys are the JAX package's
(recorded from its profiled build in tests/data/jax_port_refs.json
``tools``), filled from the build's spans (empty without the knob), and
``wq`` is bitwise equal with the knob on and off; the
density and orbital kernels equal the JAX package's on the same seeded AO
tensor to 1e-12 relative; the cube cases are tests/test_cube.py's, on the
port's own SCF of diamond gth-szv (an ISDF KRHF, c0 10, m0 9^3, where the
JAX test runs the exact one: the cube layer reads only the density and
orbitals; the grid quadrature is the SCF's, so the integrals hold to the
cube text's 5 digits, 1e-4, and in memory to roundoff).
"""
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.utils import cube as jax_cube
from fftisdf_tpu.utils.config import ISDFConfig as JaxConfig
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import KRHF, KUHF
from fftisdf_tpu_torch.utils import cube, profiling
from fftisdf_tpu_torch.utils.config import ISDFConfig
from fftisdf_tpu_torch.utils.logging import Logger

REFS = json.loads((Path(__file__).parent / "data"
                   / "jax_port_refs.json").read_text())


def _diamond(pkg=structure):
    cell = pkg.to_cell(*pkg.bulk_diamond(), basis="gth-szv",
                       pseudo="gth-pade", ke_cutoff=50.0)
    return cell, cell.get_kpts([1, 1, 2])


def test_config_roundtrip():
    """tests/test_utils.py::test_config_roundtrip, and the JAX package's
    fields and defaults."""
    cfg = ISDFConfig(c0=30.0, m0=(9, 9, 9), solver="svd", kmesh=(2, 2, 2))
    cfg2 = ISDFConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    kw = cfg.isdf_kwargs()
    assert kw["c0"] == 30.0 and kw["solver"] == "svd"
    assert ISDFConfig().to_json() == JaxConfig().to_json()
    assert cfg.to_json() == JaxConfig.from_json(cfg.to_json()).to_json()


def test_profiling_phase_scope_and_trace(tmp_path):
    """tests/test_utils.py::test_profiling_phase_scope on the port's span
    (the JAX package's phase): its log line where a caller passes a
    logger, none without one, and a host trace written as a Chrome trace
    holding the span's range; the card's trace refuses to run without
    CUDA."""
    import io

    buf = io.StringIO()
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("unit-test-phase", log=Logger(3, stream=buf)):
            x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert "wall time for unit-test-phase" in buf.getvalue()
    with profiling.span("unit-test-phase", log=Logger(3, stream=buf)):
        pass
    assert buf.getvalue().count("wall time for unit-test-phase") == 2
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert any(e.get("name") == "unit-test-phase"
               for e in events["traceEvents"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with profiling.trace(str(tmp_path / "card")):
                pass


def test_profile_build_stages_and_bitwise_wq():
    """On diamond 1x1x2: profile_build fills _stage_s with exactly the JAX
    package's keys from the build's spans, their sum within the metric
    pass, an unprofiled build leaves it empty, and w_q is bitwise the
    same with the knob on and off."""
    cell, kpts = _diamond()
    kw = dict(c0=10.0, m0=(9, 9, 9), verbose=0, device="cpu")
    plain = FFTISDF(cell, kpts, **kw).build()
    prof = FFTISDF(cell, kpts, profile_build=True, **kw).build()
    assert list(prof._stage_s) == REFS["tools"]["stage_keys"]
    assert plain._stage_s == {}
    assert torch.equal(prof.wq, plain.wq)
    assert np.array_equal(prof.mask, plain.mask)
    assert prof.timings["select_s"] > 0
    assert all(v > 0 for v in prof._stage_s.values())
    stages = sum(prof._stage_s.values())
    assert 0 < stages <= prof.timings["metric_s"]
    assert set(prof.timings) == set(plain.timings)
    assert profiling.drain() == {"spans": [], "counts": {}}


def test_rho_and_mo_kernels_match_jax():
    """The port's density and orbital kernels against the JAX package's
    ``_rho_kernel`` / ``_mo_kernel`` on the same seeded AO tensor and
    density: 1e-12 relative."""
    rng = np.random.default_rng(3)
    nk, ng, nao = 3, 40, 6
    ao = (rng.standard_normal((nk, ng, nao))
          + 1j * rng.standard_normal((nk, ng, nao)))
    c = rng.standard_normal((nk, nao, nao)) \
        + 1j * rng.standard_normal((nk, nao, nao))
    dm = c @ c.conj().transpose(0, 2, 1)
    rho_j = np.asarray(jax_cube._rho_kernel(jnp.asarray(ao), jnp.asarray(dm)))
    rho = cube.rho_kernel(torch.from_numpy(ao), torch.from_numpy(dm)).numpy()
    assert rho.dtype == np.float64 and rho.shape == (ng,)
    assert np.abs(rho - rho_j).max() <= 1e-12 * np.abs(rho_j).max()
    psi_j = np.asarray(jax_cube._mo_kernel(jnp.asarray(ao[1]),
                                           jnp.asarray(c[1][:, 2])))
    psi = cube.mo_kernel(torch.from_numpy(ao[1]),
                         torch.from_numpy(c[1][:, 2])).numpy()
    assert np.abs(psi - psi_j).max() <= 1e-12 * np.abs(psi_j).max()


def test_write_cube_byte_equal(tmp_path):
    """The same cell and field give the JAX package's file, byte for
    byte; read_cube parses it back."""
    cell, _ = _diamond()
    cell_j, _ = _diamond(jax_structure)
    field = np.random.default_rng(0).standard_normal(
        int(np.prod(cell.mesh)))
    path = cube.write_cube(tmp_path / "port.cube", cell, field,
                           comment="seeded field")
    path_j = jax_cube.write_cube(tmp_path / "jax.cube", cell_j, field,
                                 comment="seeded field")
    assert Path(path).read_bytes() == Path(path_j).read_bytes()
    meta, back = cube.read_cube(path)
    meta_j, back_j = jax_cube.read_cube(path_j)
    assert np.array_equal(back, back_j) and np.array_equal(
        meta["voxels"], meta_j["voxels"]) and meta["atoms"] == meta_j["atoms"]


# ------------------------------- tests/test_cube.py on the port's own SCF
@pytest.fixture(scope="module")
def diamond_rhf():
    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build()
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-9, device="cpu")
    mf.kernel()
    assert mf.converged
    return mf


def test_density_cube_roundtrip(diamond_rhf, tmp_path):
    mf = diamond_rhf
    path = cube.write_density_cube(mf, tmp_path / "rho.cube")
    meta, field = cube.read_cube(path)
    cell = mf.cell
    assert np.array_equal(meta["mesh"], np.asarray(cell.mesh))
    np.testing.assert_allclose(
        meta["voxels"], np.asarray(cell.a) / np.asarray(cell.mesh)[:, None],
        atol=1e-6)
    assert len(meta["atoms"]) == cell.natm
    # carbon with GTH pseudo: Z=6 in the element column, zion=4 as charge
    assert meta["atoms"][0][0] == 6
    np.testing.assert_allclose(meta["atoms"][0][1], 4.0)
    vox_vol = abs(np.linalg.det(meta["voxels"]))
    np.testing.assert_allclose(field.sum() * vox_vol, cell.nelectron,
                               rtol=1e-4)
    assert field.min() > -1e-10  # densities are nonnegative


def test_spin_density_channels(diamond_rhf, monkeypatch):
    mf0 = diamond_rhf
    mf = KUHF(mf0.cell, mf0.kpts, mf0.with_df, verbose=0, conv_tol=1e-8,
              max_cycle=60, device="cpu")
    mf.kernel(dm0=np.stack([mf0.dm, mf0.dm]) * 0.5)
    assert mf.converged
    rho_t = cube.density_on_grid(mf)
    rho_a = cube.density_on_grid(mf, spin=0)
    rho_b = cube.density_on_grid(mf, spin=1)
    rho_d = cube.density_on_grid(mf, spin="diff")
    np.testing.assert_allclose(rho_a + rho_b, rho_t, atol=1e-10)
    np.testing.assert_allclose(rho_a - rho_b, rho_d, atol=1e-10)
    # closed shell: zero spin density
    np.testing.assert_allclose(rho_d, 0.0, atol=1e-6)
    # the grid blocks (sized from free memory) change no value
    monkeypatch.setattr(cube, "memory_blocks", lambda n, per, dev: [
        slice(i, min(n, i + 97)) for i in range(0, n, 97)])
    np.testing.assert_allclose(cube.density_on_grid(mf), rho_t, rtol=0,
                               atol=1e-14 * rho_t.max())
    with pytest.raises(ValueError):
        cube.density_on_grid(mf0, spin=0)


def test_mo_cube_normalization(diamond_rhf, tmp_path):
    mf = diamond_rhf
    path = cube.write_mo_cube(mf, tmp_path / "mo.cube", k=0, n=0,
                              part="abs2")
    meta, field = cube.read_cube(path)
    vox_vol = abs(np.linalg.det(meta["voxels"]))
    # C^H S C = 1 and S is the grid quadrature, so the integral is exact
    # up to the 5-digit cube text format
    np.testing.assert_allclose(field.sum() * vox_vol, 1.0, rtol=1e-4)
    # in memory the integral is exact to roundoff
    psi2 = cube.mo_on_grid(mf, k=1, n=1, part="abs2")
    dv = float(mf.cell.vol) / psi2.size
    np.testing.assert_allclose(psi2.sum() * dv, 1.0, rtol=1e-10)
    re = cube.mo_on_grid(mf, k=1, n=1, part="real")
    im = cube.mo_on_grid(mf, k=1, n=1, part="imag")
    np.testing.assert_allclose(re * re + im * im, psi2, rtol=0,
                               atol=1e-12 * psi2.max())


def test_write_rejects_wrong_size(diamond_rhf, tmp_path):
    mf = diamond_rhf
    with pytest.raises(ValueError):
        cube.write_cube(tmp_path / "bad.cube", mf.cell, np.ones(7))
