"""Gaussian basis-set and GTH pseudopotential data (the port's copy).

A copy of the tables and loaders of the JAX package's
``fftisdf_tpu/basis/data.py`` that the port calls: ``ATOMIC_NUMBER``,
``element_symbol``, ``load_basis``, ``discard_diffuse``, ``GTHPseudo`` and
``load_pseudo``.  The numbers are the same, digit for digit; the
provenance of each entry is documented there.  The CP2K-format parsers and
the registration of external tables stay in the JAX package: where the
comments below name ``load_cp2k_data_files``, they mean that package's.

- STO-3G entries are the standard published Hehre-Stewart-Pople values.
- GTH basis entries follow the CP2K ``GTH_BASIS_SETS`` tables; GTH-PADE
  pseudopotentials follow the Goedecker-Teter-Hutter 1996 parameterization as
  tabulated in CP2K ``GTH_POTENTIALS``.
- Entries marked ``# in-repo surrogate`` are basis columns derived from the
  shipped pseudo-atoms rather than transcribed tables.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from fftisdf_tpu_torch.lattice.cell import Shell

ATOMIC_NUMBER = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30,
}

# standard atomic weights (amu): the masses of the dynamics and vibrational
# drivers
ATOMIC_MASS = {
    "H": 1.008, "He": 4.002602, "Li": 6.94, "Be": 9.0121831, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163, "Ne": 20.1797,
    "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815385, "Si": 28.085,
    "P": 30.973761998, "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.0983,
    "Ca": 40.078, "Sc": 44.955908, "Ti": 47.867, "V": 50.9415,
    "Cr": 51.9961, "Mn": 54.938044, "Fe": 55.845, "Co": 58.933194,
    "Ni": 58.6934, "Cu": 63.546, "Zn": 65.38,
}


def element_symbol(label: str) -> str:
    """'Ni1' / 'ni' / 'O@2' -> canonical element symbol."""
    m = re.match(r"([A-Za-z]{1,2})", label)
    if not m:
        raise ValueError(f"cannot parse element from {label!r}")
    sym = m.group(1).capitalize()
    if sym not in ATOMIC_NUMBER and sym[:1] in ATOMIC_NUMBER:
        sym = sym[:1]
    return sym


# =====================================================================
# basis sets
# =====================================================================
# Internal storage: {basis_name: {element: [(l, [(exp, c1, c2, ...), ...])]}}
# i.e. per shell: angular momentum and rows of (exponent, coeff per
# contraction).  Coefficients are the raw table values; normalization happens
# in fftisdf_tpu_torch.basis.gto.

_STO3G_SP_S = [-0.09996723, 0.39951283, 0.70011547]
_STO3G_SP_P = [0.15591627, 0.60768372, 0.39195739]
_STO3G_1S = [0.15432897, 0.53532814, 0.44463454]

_BASIS = {
    "sto-3g": {
        "H": [
            (0, [(3.42525091, 0.15432897),
                 (0.62391373, 0.53532814),
                 (0.16885540, 0.44463454)]),
        ],
        "He": [
            (0, [(6.36242139, 0.15432897),
                 (1.15892300, 0.53532814),
                 (0.31364979, 0.44463454)]),
        ],
        "C": [
            (0, [(71.6168370, _STO3G_1S[0]),
                 (13.0450960, _STO3G_1S[1]),
                 (3.5305122, _STO3G_1S[2])]),
            (0, [(2.9412494, _STO3G_SP_S[0]),
                 (0.6834831, _STO3G_SP_S[1]),
                 (0.2222899, _STO3G_SP_S[2])]),
            (1, [(2.9412494, _STO3G_SP_P[0]),
                 (0.6834831, _STO3G_SP_P[1]),
                 (0.2222899, _STO3G_SP_P[2])]),
        ],
        "N": [
            (0, [(99.1061690, _STO3G_1S[0]),
                 (18.0523120, _STO3G_1S[1]),
                 (4.8856602, _STO3G_1S[2])]),
            (0, [(3.7804559, _STO3G_SP_S[0]),
                 (0.8784966, _STO3G_SP_S[1]),
                 (0.2857144, _STO3G_SP_S[2])]),
            (1, [(3.7804559, _STO3G_SP_P[0]),
                 (0.8784966, _STO3G_SP_P[1]),
                 (0.2857144, _STO3G_SP_P[2])]),
        ],
        "O": [
            (0, [(130.7093200, _STO3G_1S[0]),
                 (23.8088610, _STO3G_1S[1]),
                 (6.4436083, _STO3G_1S[2])]),
            (0, [(5.0331513, _STO3G_SP_S[0]),
                 (1.1695961, _STO3G_SP_S[1]),
                 (0.3803890, _STO3G_SP_S[2])]),
            (1, [(5.0331513, _STO3G_SP_P[0]),
                 (1.1695961, _STO3G_SP_P[1]),
                 (0.3803890, _STO3G_SP_P[2])]),
        ],
    },
    # CP2K GTH_BASIS_SETS
    "gth-szv": {
        "H": [  # corroborated in-repo: matches the GTH-PADE H pseudo-atom's
            # own 1s orbital in this primitive set (cos 0.994)
            (0, [(8.3744350009, -0.0283380461),
                 (1.8058681460, -0.1333810052),
                 (0.4852528328, -0.3995676063),
                 (0.1658236932, -0.5531027541)]),
        ],
        "C": [
            (0, [(4.3362376436, 0.1490797872),
                 (1.2881838513, -0.0292640031),
                 (0.4037767149, -0.6891027884),
                 (0.1187877657, -0.3793420844)]),
            (1, [(4.3362376436, -0.0878123619),
                 (1.2881838513, -0.2775560300),
                 (0.4037767149, -0.4712295093),
                 (0.1187877657, -0.4058039291)]),
        ],
        # corroborated in-repo (examples/derive_atomic_basis.py machinery):
        # these coefficients match the GTH-PADE O pseudo-atom's own 2s/2p
        # orbitals in this primitive set (cos 0.98 / 0.998), and the set is
        # variationally better than an alternative offline transcription by
        # 75 mHa at the uncontracted level — consistent with the genuine
        # (atomic-contraction) GTH_BASIS_SETS entry; digit-level diffing
        # against upstream is impossible offline.
        "O": [
            (0, [(10.2674419938, 0.0989598460),
                 (3.0734354886, -0.0595856940),
                 (0.9874955953, -0.5086561686),
                 (0.2798990973, -0.5774631964)]),
            (1, [(10.2674419938, -0.0709762331),
                 (3.0734354886, -0.2673866739),
                 (0.9874955953, -0.4458051839),
                 (0.2798990973, -0.4115281903)]),
        ],
        "Ni": [  # in-repo surrogate: 3-exponent sp + d contraction for q18
            # Ni, columns re-derived (fit_radial_gaussians) from the REFIT
            # pseudo-atom's 3s/3p/3d states (basis/data.py Ni GTH provenance
            # note; the previous columns were tied to the corrupted pseudo
            # transcription).  Single-zeta structure: the 4s has no column.
            (0, [(5.3910749540, -0.2942672500),
                 (1.6380684929, 1.0724373800),
                 (0.5134371191, 0.1574444300)]),
            (1, [(5.3910749540, 0.1968444900),
                 (1.6380684929, 0.7657640300),
                 (0.5134371191, 0.1376413100)]),
            (2, [(5.3910749540, 0.4723842600),
                 (1.6380684929, 0.4017662700),
                 (0.5134371191, 0.4010201100)]),
        ],
    },
    "gth-dzvp": {
        "C": [
            (0, [(4.3362376436, 0.1490797872, 0.0),
                 (1.2881838513, -0.0292640031, 0.0),
                 (0.4037767149, -0.6891027884, 0.0),
                 (0.1187877657, -0.3793420844, 1.0)]),
            (1, [(4.3362376436, -0.0878123619, 0.0),
                 (1.2881838513, -0.2775560300, 0.0),
                 (0.4037767149, -0.4712295093, 0.0),
                 (0.1187877657, -0.4058039291, 1.0)]),
            (2, [(0.5500000000, 1.0)]),
        ],
        "O": [  # szv contraction (corroborated — see gth-szv note) + split
            # valence on the most diffuse primitive + d polarization
            (0, [(10.2674419938, 0.0989598460, 0.0),
                 (3.0734354886, -0.0595856940, 0.0),
                 (0.9874955953, -0.5086561686, 0.0),
                 (0.2798990973, -0.5774631964, 1.0)]),
            (1, [(10.2674419938, -0.0709762331, 0.0),
                 (3.0734354886, -0.2673866739, 0.0),
                 (0.9874955953, -0.4458051839, 0.0),
                 (0.2798990973, -0.4115281903, 1.0)]),
            (2, [(1.1850000000, 1.0)]),
        ],
        "H": [
            (0, [(8.3744350009, -0.0283380461, 0.0),
                 (1.8058681460, -0.1333810052, 0.0),
                 (0.4852528328, -0.3995676063, 0.0),
                 (0.1658236932, -0.5531027541, 1.0)]),
            (1, [(0.7270000000, 1.0)]),
        ],
        "Ni": [  # in-repo surrogate: szv sp/d contractions (re-derived from
            # the refit pseudo-atom — see the gth-szv Ni note) doubled with
            # an uncontracted diffuse function (4s/4p reach) + f-free
            # polarization
            (0, [(5.3910749540, -0.2942672500, 0.0),
                 (1.6380684929, 1.0724373800, 0.0),
                 (0.5134371191, 0.1574444300, 0.0),
                 (0.1670000000, 0.0, 1.0)]),
            (1, [(5.3910749540, 0.1968444900, 0.0),
                 (1.6380684929, 0.7657640300, 0.0),
                 (0.5134371191, 0.1376413100, 0.0),
                 (0.1670000000, 0.0, 1.0)]),
            (2, [(5.3910749540, 0.4723842600, 0.0),
                 (1.6380684929, 0.4017662700, 0.0),
                 (0.5134371191, 0.4010201100, 0.0),
                 (0.1670000000, 0.0, 1.0)]),
        ],
    },
    # CP2K BASIS_MOLOPT structure: ONE set of shared exponents contracted
    # into every shell (2s 2p 1d for first-row DZVP-MOLOPT-SR-GTH) — the
    # molecularly-optimized short-range family the reference's production
    # config names (``basis='gth-dzvp-molopt-sr'``, fftisdf.py:423).
    # Provenance: transcribed from CP2K BASIS_MOLOPT to the best available
    # precision in this offline environment (no network, no CP2K install to
    # verify against — see the module docstring); H and Ni carry in-repo
    # surrogate coefficients in the authentic MOLOPT structure and are the
    # entries to replace via load_cp2k_data_files for external-energy
    # comparisons.
    "gth-dzvp-molopt-sr": {
        "O": [
            (0, [(10.389228018317, 0.126240722900, 0.069215797900),
                 (3.849621072005, 0.139933704300, 0.115634538900),
                 (1.388401188741, -0.434348231700, -0.322839719400),
                 (0.496955043655, -0.852791790900, -0.095944016600),
                 (0.162491615040, -0.242351537800, 1.102830348700)]),
            (1, [(10.389228018317, -0.061302037200, -0.026862701100),
                 (3.849621072005, -0.190087511700, -0.006283021000),
                 (1.388401188741, -0.377726982800, -0.224839187800),
                 (0.496955043655, -0.454266086000, 0.380324658600),
                 (0.162491615040, -0.257388983000, 1.054102919900)]),
            (2, [(10.389228018317, 0.029845227500),
                 (3.849621072005, 0.060939733900),
                 (1.388401188741, 0.732321580100),
                 (0.496955043655, 0.893564918400),
                 (0.162491615040, 0.152954188700)]),
        ],
        "H": [  # surrogate coefficients in the authentic MOLOPT structure
            # (shared exponents); MOLOPT columns are molecularly optimized,
            # so the atomic-orbital corroboration that pins the GTH tables
            # does not apply — replace via load_cp2k_data_files (or derive
            # in-repo columns via examples/derive_atomic_basis.py) for
            # external-energy comparisons
            (0, [(10.068468228533, 0.009549793900, -0.012000417500),
                 (2.680222868089, 0.049211313500, -0.056779903500),
                 (0.791501539122, 0.205868146700, -0.304738005400),
                 (0.239116151100, 0.352369612900, -0.197107222000),
                 (0.082193184500, 0.368612051500, 0.334767540700)]),
            (1, [(10.068468228533, 0.024752996000),
                 (2.680222868089, 0.078370655700),
                 (0.791501539122, 0.237342096900),
                 (0.239116151100, 0.318424831200),
                 (0.082193184500, 0.070129863700)]),
        ],
        "Ni": [  # in-repo columns in the authentic MOLOPT structure: 6
            # shared exponents spanning semicore 3s3p through diffuse 4s,
            # contracted to 2s 2p 2d (q18 valence 3s 3p 3d 4s).  Derived
            # from the REFIT pseudo-atom's radial states
            # (examples/derive_atomic_basis.py --elem Ni --radial): leading
            # columns are the occupied 3s/4s, 3p, 3d fits; split columns
            # are the channel virtual (s) / diffuse-primitive fallback
            # Gram-orthogonalized against the leading column (p, d).
            # MOLOPT columns are molecularly optimized, so digit-level
            # parity with CP2K is not claimed — replace via
            # load_cp2k_data_files for external-energy comparisons.
            (0, [(9.6538632696, -0.2259297010, 0.0313669870),
                 (3.9744501290, 0.0243166380, 0.1088943980),
                 (1.6213478542, 0.8822033880, -0.5551066650),
                 (0.6447664764, 0.2213218920, 0.0811490500),
                 (0.2513317635, 0.0179113030, -0.0975757430),
                 (0.0971124480, -0.0040471310, 1.1058960690)]),
            (1, [(9.6538632696, -0.0706620470, 0.0128973440),
                 (3.9744501290, 0.3844215230, -0.0701652010),
                 (1.6213478542, 0.5524616580, -0.1008361420),
                 (0.6447664764, 0.2054860080, -0.0375056190),
                 (0.2513317635, 0.0087808260, -0.0016026900),
                 (0.0971124480, 0.0004275440, 0.9999219640)]),
            (2, [(9.6538632696, 0.1843943750, -0.0434302320),
                 (3.9744501290, 0.3526680850, -0.0830635800),
                 (1.6213478542, 0.3447662150, -0.0812024600),
                 (0.6447664764, 0.2935276360, -0.0691342860),
                 (0.2513317635, 0.1414343040, -0.0333118870),
                 (0.0971124480, 0.0356638390, 0.9916001300)]),
        ],
    },
}

# name aliases, normalized to lowercase without separators
_BASIS_ALIASES = {
    "sto3g": "sto-3g",
    "gthszv": "gth-szv",
    "gthdzvp": "gth-dzvp",
    "gthdzvpmoloptsr": "gth-dzvp-molopt-sr",
    "dzvpmoloptsrgth": "gth-dzvp-molopt-sr",
    "gthszvmoloptsr": "gth-szv-molopt-sr",
    "szvmoloptsrgth": "gth-szv-molopt-sr",
}

# family -> fallback family for elements without an entry; each fallback
# use emits a single loud warning
_BASIS_FALLBACKS = {
    "gth-dzvp-molopt-sr": "gth-dzvp",
    "gth-szv-molopt-sr": "gth-szv",
}
_WARNED_FALLBACKS = set()


def _norm_name(name: str) -> str:
    return re.sub(r"[-_ ]", "", name.lower())



def load_basis(name: str, symbol: str) -> list:
    import warnings

    sym = element_symbol(symbol)
    key = _BASIS_ALIASES.get(_norm_name(name), name)
    if key not in _BASIS and key in _BASIS_FALLBACKS:
        if (key, "*") not in _WARNED_FALLBACKS:
            _WARNED_FALLBACKS.add((key, "*"))
            warnings.warn(
                f"basis family {key!r} has no embedded tables: falling "
                f"back to {_BASIS_FALLBACKS[key]!r}", stacklevel=2)
        key = _BASIS_FALLBACKS[key]
    if key not in _BASIS:
        raise KeyError(f"unknown basis set {name!r}")
    if sym not in _BASIS[key]:
        fb = _BASIS_FALLBACKS.get(key)
        if fb is not None and sym in _BASIS.get(fb, {}):
            if (key, sym) not in _WARNED_FALLBACKS:
                _WARNED_FALLBACKS.add((key, sym))
                warnings.warn(
                    f"no {key!r} entry for {sym!r}: falling back to {fb!r} "
                    "(the JAX package's load_cp2k_data_files registers "
                    "real tables for molopt-sr parity)",
                    stacklevel=2)
            key = fb
        else:
            raise KeyError(f"no {name!r} entry for element {sym!r}")
    shells = []
    for l, rows in _BASIS[key][sym]:
        rows = np.asarray(rows, dtype=np.float64)
        shells.append(Shell(l=l, exps=rows[:, 0], coeffs=rows[:, 1:]))
    return shells


def discard_diffuse(shells: list, exp_to_discard: float) -> list:
    """Drop primitives with exponent < exp_to_discard (ref uses
    ``cell.exp_to_discard = 0.1``, ``fftisdf.py:428``).  Contractions that lose
    all primitives are dropped entirely."""
    out = []
    for sh in shells:
        keep = sh.exps >= exp_to_discard
        if not keep.any():
            continue
        coeffs = sh.coeffs[keep]
        # drop contracted functions that became identically zero
        nonzero = np.abs(coeffs).max(axis=0) > 0
        if not nonzero.any():
            continue
        out.append(Shell(l=sh.l, exps=sh.exps[keep], coeffs=coeffs[:, nonzero]))
    return out



# =====================================================================
# GTH pseudopotentials
# =====================================================================

@dataclass
class GTHPseudo:
    """Goedecker-Teter-Hutter separable pseudopotential.

    V(r) = V_loc(r) + sum_{l,ij} |p_i^l> h^l_ij <p_j^l|

    V_loc(r) = -Zion/r * erf(r / (sqrt(2) rloc))
               + exp(-r^2/(2 rloc^2)) * sum_i cloc[i] * (r/rloc)^(2i)

    p_i^l(r) ~ r^(l + 2(i-1)) exp(-r^2/(2 rl^2)), normalized.
    """
    zion: float
    rloc: float
    cloc: np.ndarray                       # (<=4,)
    projectors: list = field(default_factory=list)  # [(l, rl, h (ni,ni))]
    approximate: bool = False

    @property
    def nelec(self) -> float:
        return self.zion


def _h(*rows):
    n = len(rows)
    m = np.zeros((n, n))
    for i, r in enumerate(rows):
        for j, v in enumerate(r):
            m[i, i + j] = v
            m[i + j, i] = v
    return m


_PSEUDO_PADE = {
    "H": GTHPseudo(1, 0.20000000, np.array([-4.18023680, 0.72507482])),
    "He": GTHPseudo(2, 0.20000000, np.array([-9.11202340, 1.69836797])),
    "C": GTHPseudo(4, 0.34883045, np.array([-8.51377110, 1.22843203]),
                   [(0, 0.30455321, _h([9.52284179]))]),
    "N": GTHPseudo(5, 0.28917923, np.array([-12.23481988, 1.76640728]),
                   [(0, 0.25660487, _h([13.55224272]))]),
    "O": GTHPseudo(6, 0.24762086, np.array([-16.58031797, 2.39570092]),
                   [(0, 0.22178614, _h([18.26691718]))]),
    # Si h22: the original transcription carried 2.93454196, which violates
    # the HGH-1998 off-diagonal relation h12 = -1/2 sqrt(3/5) h22 by 4.3e-2
    # and misses the AE valence 3s by 21 mHa in the radial pseudo-atom
    # (tests/test_atom.py); 3.25819622 (the GTH-96 value h12/kappa_0
    # implies exactly) satisfies the relation to 4e-11 and restores ~1e-3
    # agreement — the corrected digit is derived, not externally diffed.
    "Si": GTHPseudo(4, 0.44000000, np.array([-7.33610297]),
                    [(0, 0.42273813, _h([5.90692831, -1.26189397],
                                        [3.25819622])),
                     (1, 0.48427842, _h([2.65558236]))]),
    # Ni q18 semicore (3s 3p 3d 4s valence).  IN-REPO REFIT (basis/fit.py):
    # the offline transcription of the HGH-1998 entry failed the
    # all-electron provenance discriminator by 4.75 Ha (genuine tables land
    # <~2e-3 Ha on this solver, calibrated on the verified H/C/O/Si
    # entries), so the table was re-generated by the original GTH-96
    # procedure — least-squares match of the radial pseudo-atom's valence
    # eigenvalues AND partial charges q(rcov) to the in-repo all-electron
    # LDA atom (Goedecker-Teter-Hutter PRB 54, 1703 (1996) sec. II), with
    # the radii held at their transcribed values and the HGH off-diagonal
    # relations enforced exactly.  Post-fit: max eigenvalue error 3.0e-4 Ha,
    # max charge error 1.3e-4 e, virtual spectrum ghost-free (the lone
    # sub-continuum virtual is the physical 4p at -0.048 Ha).  The fitter
    # is gated by recovering the genuine C table from a corrupted start
    # (tests/test_atom.py::test_fit_gth_recovers_genuine_carbon).
    "Ni": GTHPseudo(18, 0.35000000, np.array([40.05008620, -4.14764360]),
                    [(0, 0.24510489, _h([-3.97479722, 6.08439644],
                                        [-15.70984406])),
                     (1, 0.23474009, _h([-12.55359528, 4.91989950],
                                        [-11.64260720])),
                     (2, 0.21447951, _h([-27.11407336]))]),
}

_PSEUDO_LIBRARY = {"gth-pade": _PSEUDO_PADE}
_PSEUDO_ALIASES = {"gthpade": "gth-pade"}



def load_pseudo(name: str, symbol: str) -> GTHPseudo:
    sym = element_symbol(symbol)
    key = _PSEUDO_ALIASES.get(_norm_name(name), name)
    if key not in _PSEUDO_LIBRARY:
        raise KeyError(f"unknown pseudopotential {name!r}")
    if sym not in _PSEUDO_LIBRARY[key]:
        raise KeyError(f"no {name!r} entry for element {sym!r}")
    return _PSEUDO_LIBRARY[key][sym]
