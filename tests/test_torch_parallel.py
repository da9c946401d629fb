"""The port's mesh layer (``fftisdf_tpu_torch.parallel``) on 2 gloo ranks
of CPU processes, against the port on one device and against the JAX
package's sharded results.

The cases are tests/test_parallel.py's, on its He2 ``he2k8`` cell and at
its gates: the sharded build and serve (J/K 1e-6; the serve of a
single-device build 1e-10), a 1-rank subgroup, time-reversal halving on
1x1x3, a budget that forces sector chunks (w_q 1e-10 of the unchunked
sharded build), ``refine`` passed through (1e-8), the 0D-truncated and
screened (omega 0.4) kernels (1e-6), and the force state's value (1e-10)
and gradient (2e-5 of max(1, max|g|)), the CCSD update on seeded random
inputs (nk 8, 1e-12) and kccsd on the H2 chain (1e-10).  Raw w_q differs
between execution paths in near-null fit directions, so J/K and energies
are held, not w_q, except where the two builds share one path.  The ranks
run once for the module (tests/torch_parallel_cases.py, which never
imports JAX).

Against the JAX package: its 2-device sharded J/K on he2k8 and its mask
are recorded (tests/jax_records.py); the port's 2-rank sharded build is
given that mask and held to those J/K at 1e-6; its 8-device sharded
CCSD update is recorded, and the port's 2-rank update held to it at
1e-12."""
import numpy as np
import pytest

import torch_parallel_cases as cases
from fftisdf_tpu_torch.parallel.dryrun import spawn
from jax_records import recorded
from test_isdf_kpoint import trs_dm


def _jax_sharded_he2k8(dm):
    """The JAX package's 2-device sharded build and J/K on he2k8."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.parallel import build_sharded, make_device_mesh
    from test_parallel import he2k8 as _he2k8

    cell, kpts = _he2k8.__wrapped__()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(5, 5, 7), verbose=0)
    build_sharded(df, make_device_mesh(n_devices=2))
    vj, vk = df.get_jk(dm)
    return np.asarray(df.mask), np.asarray(vj), np.asarray(vk)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cell, kpts = cases.he2k8()
    nao = cell.nao_nr()
    dm8 = trs_dm(cell, kpts, nao)[0]
    dm3 = trs_dm(cell, cell.get_kpts([1, 1, 3]), nao)[0]
    jax_mask, vj_j, vk_j = recorded("parallel/he2k8_sharded2",
                                    lambda: _jax_sharded_he2k8(dm8))
    cc_j = recorded("parallel/ccsd_step_sharded8", _jax_sharded_ccsd_step)
    store = tmp_path_factory.mktemp("rendezvous") / "store"
    res = spawn(_all_cases, 2, backend="gloo", device="cpu",
                args=(dm8, dm3, np.asarray(jax_mask)),
                init_method=f"file://{store}", threads=1, timeout_s=600)
    return res, (vj_j, vk_j), cc_j


def _jax_sharded_ccsd_step():
    """The JAX package's CCSD update over its 8-device mesh, on the
    seeded inputs of tests/test_parallel.py (t2 packed (nk, nk, nk, ...))."""
    import jax.numpy as jnp
    from fftisdf_tpu.parallel import make_device_mesh
    from fftisdf_tpu.scf import cc as cc_j

    nk, no, nv, kp3, eo, ev, u, t1, t2 = cases.ccsd_step_inputs()
    t2d = {(a, b, c): jnp.asarray(t2[a, b, c]) for a in range(nk)
           for b in range(nk) for c in range(nk)}
    step = cc_j.make_step(nk, no, nv, kp3, eo, ev, mesh=make_device_mesh())
    t1n, t2n, e = step(jnp.asarray(t1), t2d, jnp.asarray(u))
    packed = np.stack([np.asarray(t2n[a, b, c]) for a in range(nk)
                       for b in range(nk) for c in range(nk)])
    return (np.asarray(t1n), packed.reshape(t2.shape),
            np.asarray(complex(e)))


def _all_cases(mesh, dm8, dm3, jax_mask):
    return dict(build=cases.build_cases(mesh, dm8, dm3, jax_mask),
                force=cases.force_case(mesh),
                force_chunked=cases.force_case(mesh, budget=5e-4),
                ccsd_step=cases.ccsd_step_case(mesh),
                ccsd_slabs=cases.ccsd_step_case(mesh, slabs=True),
                kccsd=cases.kccsd_case(mesh))


def _each(ranks, key):
    return [r["build"][key] for r in ranks[0]]


@pytest.mark.parametrize("key, gate", [("build", 1e-6), ("serve", 1e-10),
                                       ("trs", 1e-6), ("no_trs", 1e-6),
                                       ("refine", 1e-8), ("trunc0d", 1e-6),
                                       ("omega", 1e-6)])
def test_sharded_matches_single(ranks, key, gate):
    for d in _each(ranks, key):
        assert d < gate, (key, d)


def test_sharded_build_layout(ranks):
    assert all(_each(ranks, "build_mask_equal"))
    qs = _each(ranks, "qs")
    # the 8 sectors of he2k8, split over the two ranks
    assert sorted(qs[0] + qs[1]) == list(range(8)) and qs[0] and qs[1]
    # the host ranks the module asked for: gloo on the CPU
    assert _each(ranks, "backend") == ["gloo", "gloo"]
    assert _each(ranks, "device") == ["cpu", "cpu"]


def test_sharded_on_subset_mesh(ranks):
    res = ranks[0]
    assert res[0]["build"]["subset"] < 1e-6
    assert "subset" not in res[1]["build"]


def test_sharded_build_trs_halving(ranks):
    assert all(_each(ranks, "trs_mirror_owner"))


def test_sharded_build_sector_chunked(ranks):
    for n, d in zip(_each(ranks, "chunks"), _each(ranks, "chunked_wq")):
        assert n >= 2 and d < 1e-10, (n, d)


def test_sharded_build_refine_threaded(ranks):
    # refine is not a no-op at this rcond: refine=0 differs more
    assert all(d > 1e-8 for d in _each(ranks, "refine0_vs_2"))


def test_sharded_jk_matches_jax_sharded(ranks):
    """The port's 2-rank build on the JAX mask against the JAX package's
    2-device sharded J/K."""
    vj_j, vk_j = ranks[1]
    for vj, vk in _each(ranks, "jax_mask_jk"):
        np.testing.assert_allclose(vj, vj_j, atol=1e-6)
        np.testing.assert_allclose(vk, vk_j, atol=1e-6)


@pytest.mark.parametrize("which", ["force", "force_chunked"])
def test_sharded_force_state_gradient_matches_single(ranks, which):
    """The sharded differentiable state (isdf_state_fn(dev_mesh=)), whole
    and sector-chunked, reproduces the single-device value and gradient,
    and every rank holds the same gradient."""
    res = [r[which] for r in ranks[0]]
    for r in res:
        assert abs(r["v2"] - r["v1"]) < 1e-10
        np.testing.assert_allclose(
            r["g2"], r["g1"], atol=2e-5 * max(1.0, np.abs(r["g1"]).max()))
    np.testing.assert_array_equal(res[0]["g2"], res[1]["g2"])


@pytest.mark.parametrize("which", ["ccsd_step", "ccsd_slabs"])
def test_sharded_ccsd_step_matches_single(ranks, which):
    """The sharded CCSD update (U, W and the T2 residual split by their
    leading k index, kconserv gathers as exchanges, the slab loops of the
    ranks agreeing on a count) against the unsharded step, nk 8, random
    amplitudes and integrals, at 1e-12."""
    for r in (r[which] for r in ranks[0]):
        assert r["de"] < 1e-12 and r["dt1"] < 1e-12 and r["dt2"] < 1e-12, r


def test_sharded_ccsd_step_matches_jax_sharded(ranks):
    """The port's 2-rank step against the JAX package's 8-device sharded
    step on the same inputs, at 1e-12."""
    t1_j, t2_j, e_j = ranks[2]
    for r in (r["ccsd_step"] for r in ranks[0]):
        assert abs(r["e"] - complex(e_j)) < 1e-12
        np.testing.assert_allclose(r["t1"], t1_j, atol=1e-12)
        np.testing.assert_allclose(r["t2"], t2_j, atol=1e-12)


def test_sharded_kccsd_end_to_end(ranks):
    """kccsd(dev_mesh=) == kccsd() on the H2 chain (nk 2 over 2 ranks)."""
    for r in (r["kccsd"] for r in ranks[0]):
        assert r["converged"]
        assert abs(r["e2"] - r["e1"]) < 1e-10, r
