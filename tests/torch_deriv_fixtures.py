"""Cells and cases shared by the derivative-layer parity tests
(``tests/test_torch_autodiff_forces.py``, ``test_torch_stress.py``,
``test_torch_geometry.py``) and the JAX records they read
(``tools/jax_port_refs.py derivatives``).

Each function takes the ``Cell`` and ``Shell`` classes of the package that
builds the cell, so both packages see the same configuration: these are
the fixtures of the JAX package's derivative tests (``tests/test_forces.py``,
``test_stress.py``, ``test_autodiff.py``, ``test_optimize.py``,
``test_relax_cell.py``, ``test_hessian.py``, ``test_md.py``,
``test_phonon.py``, ``test_elastic.py``, ``test_eos.py``)."""
import numpy as np


def he2_strain(cell_cls, shell_cls, a_mat=None, box=8.0, mesh=14):
    """He2 at fixed fractions (0.35, 0.65) along z of a cubic box
    (tests/test_stress.py)."""
    shells = [shell_cls(l=0, exps=np.array([0.8, 0.3]),
                        coeffs=np.array([[0.4], [0.7]]))]
    a = np.diag([box, box, box]) if a_mat is None else np.asarray(a_mat)
    frac = np.array([[0.5, 0.5, 0.35], [0.5, 0.5, 0.65]])
    return cell_cls(a=a, atom=[("He", frac[0] @ a), ("He", frac[1] @ a)],
                    basis={"He": shells}, pseudo=None,
                    mesh=np.array([mesh] * 3), unit="bohr",
                    precision=1e-12).build()


def he2_probe(cell_cls, shell_cls):
    """He2 with an uncontracted s pair in a 5x5x6 box
    (tests/test_autodiff.py)."""
    return cell_cls(
        a=np.diag([5.0, 5.0, 6.0]),
        atom=[("He", (2.5, 2.4, 2.0)), ("He", (2.5, 2.6, 4.1))],
        basis={"He": [shell_cls(l=0, exps=np.array([1.0, 0.35]),
                                coeffs=np.eye(2))]},
        pseudo=None, mesh=np.array([9, 9, 11]), unit="bohr",
        precision=1e-12).build()


def h2(cell_cls, shell_cls, d=2.0, box=8.0, mesh=20):
    """H2 along z in a cubic box (tests/test_optimize.py, test_md.py,
    test_hessian.py)."""
    shells = [shell_cls(l=0, exps=np.array([1.3, 0.25]),
                        coeffs=np.array([[0.5], [0.6]]))]
    return cell_cls(
        a=np.diag([box, box, box]),
        atom=[("H", np.array([box / 2, box / 2, box / 2 - d / 2])),
              ("H", np.array([box / 2, box / 2, box / 2 + d / 2]))],
        basis={"H": shells}, pseudo=None, mesh=np.array([mesh] * 3),
        unit="bohr", precision=1e-12).build()


def lih(cell_cls, shell_cls, a_lat=6.8, mesh=18):
    """Rock-salt LiH, fcc primitive cell (tests/test_relax_cell.py,
    test_md.py)."""
    a = 0.5 * a_lat * (np.ones((3, 3)) - np.eye(3))
    li = [shell_cls(l=0, exps=np.array([16.0, 2.2]),
                    coeffs=np.array([[0.8], [0.3]])),
          shell_cls(l=0, exps=np.array([0.6, 0.15]),
                    coeffs=np.array([[0.5], [0.6]]))]
    h = [shell_cls(l=0, exps=np.array([1.3, 0.25]),
                   coeffs=np.array([[0.5], [0.6]]))]
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    return cell_cls(a=a, atom=[("Li", frac[0] @ a), ("H", frac[1] @ a)],
                    basis={"Li": li, "H": h}, pseudo=None,
                    mesh=np.array([mesh] * 3), unit="bohr",
                    precision=1e-12).build()


def he_sc(cell_cls, shell_cls):
    """Simple-cubic He, a = 4 bohr (tests/test_elastic.py, test_eos.py)."""
    shells = [shell_cls(l=0, exps=np.array([2.5, 0.7]),
                        coeffs=np.array([[0.6], [0.5]]))]
    return cell_cls(a=np.diag([4.0, 4.0, 4.0]), atom=[("He", np.zeros(3))],
                    basis={"He": shells}, pseudo=None,
                    mesh=np.array([10, 10, 10]), unit="bohr",
                    precision=1e-12).build()


def he_chain(cell_cls, shell_cls):
    """A He chain along z (tests/test_phonon.py)."""
    shells = [shell_cls(l=0, exps=np.array([2.5, 0.7]),
                        coeffs=np.array([[0.6], [0.5]]))]
    return cell_cls(a=np.diag([7.0, 7.0, 3.2]),
                    atom=[("He", np.array([3.5, 3.5, 0.0]))],
                    basis={"He": shells}, pseudo=None,
                    mesh=np.array([12, 12, 6]), unit="bohr",
                    precision=1e-12).build()


# Lagrangian parity cases on he2_strain at 1x1x2: (name, SCF class name,
# SCF keywords, two-electron backend).  The ISDF cases fit on c0 20, m0
# 11^3 (ISDF_BUILD); the JAX package cannot take the strain derivative of
# an ISDF screened hybrid, so "isdf_hse06" has a force record only.
CASES = [
    ("pw_rhf", "KRHF", {}, "pw"),
    ("pw_uhf", "KUHF", {}, "pw"),
    ("pw_lda", "KRKS", {"xc": "lda"}, "pw"),
    ("pw_pbe", "KRKS", {"xc": "pbe"}, "pw"),
    ("pw_lda_u", "KRKS", {"xc": "lda", "hubbard": {0: (0, 0.3)}}, "pw"),
    ("pw_scan", "KRKS", {"xc": "scan"}, "pw"),
    ("pw_hse06", "KRKS", {"xc": "hse06"}, "pw"),
    ("pw_rhf_ewald", "KRHF", {"exxdiv": "ewald"}, "pw"),
    ("isdf_rhf", "KRHF", {}, "isdf"),
    ("isdf_uhf", "KUHF", {}, "isdf"),
    ("isdf_pbe_u", "KUKS", {"xc": "pbe", "hubbard": {1: (0, 0.3)}}, "isdf"),
    ("isdf_hse06", "KRKS", {"xc": "hse06"}, "isdf"),
    ("isdf_rhf_ewald", "KRHF", {"exxdiv": "ewald"}, "isdf"),
]
ISDF_BUILD = {"c0": 20.0, "m0": (11, 11, 11)}
NO_STRESS = ("isdf_hse06",)
