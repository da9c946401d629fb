"""The port's entry points, ``fftisdf_tpu_torch.examples``, against the JAX
package's example scripts (``examples/*.py``).

(a) Every JAX script but ``multichip_aot.py`` (an XLA lowering proof
without data; its counterpart is ``python -m
fftisdf_tpu_torch.parallel.dryrun --plan``) has a port module of the same
name whose ``build_parser()`` takes the script's flags with its defaults,
read from the script's source with ``ast`` (nothing of it is imported),
and ``--device`` (``cuda``); ``--dtype`` (``float64``) stands for the
TPU's float32 where the script could run there (``--tpu``, or
nio_northstar's default); diamond_ks's own ``--device``
(the device-resident loop) is ``--device-loop``; nio_northstar's ``--out``
defaults to a new file, not to the committed JAX artifact.

(b) The examples that are cheap on the CPU run through ``main([...,
"--device", "cpu"])`` and are held to the JAX script's own output for the
same arguments, recorded in tests/data/jax_example_outputs.json
(``tools/jax_port_refs.py examples``), both parsed by the module's
result patterns, at the module's GATES: quantities that selection does
not touch (exact plane-wave energies) to 1e-8 relative, ISDF quantities
to 1e-6 Ha on the JAX run's interpolation points (passed to ``run``;
symmetric cells meet exact selection ties); thc_demo's fit, which takes
no recorded points, is held to the JAX tests' bounds on its error
report.  Each run also passes the script's own checks (``check``), and
its printed lines parse to the numbers ``main`` returns.  The rest run
on the card in chip_smoke.py's phase 15.

(c) The gates themselves: a gated key that either side did not print
fails (a module's PRINTED_IF names the keys that only some arguments
print), every record prints each gate of its arguments, and a recorded
mask is taken only on the example's own parent mesh.
"""
import ast
import importlib
import json
from pathlib import Path

import pytest
import torch

from fftisdf_tpu_torch.examples import _common

REPO = Path(__file__).resolve().parents[1]
RECORD = json.loads((REPO / "tests" / "data"
                     / "jax_example_outputs.json").read_text())["examples"]
NOT_PORTED = {"multichip_aot"}
RENAMED = {("diamond_ks", "--device"): "--device-loop"}
NEW_DEFAULTS = {("nio_northstar", "--out"):
                "artifacts/torch/nio_scf_torch.json"}


def _script_flags(path):
    """{flag: default} of every ``add_argument`` in a script's source."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        default = None
        if "default" in kw:
            default = ast.literal_eval(kw["default"])
        elif "action" in kw and ast.literal_eval(kw["action"]) == "store_true":
            default = False
        flags[ast.literal_eval(node.args[0])] = default
    return flags


def _port_flags(parser):
    return {a.option_strings[-1]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[-1] != "--help"}


SCRIPTS = sorted(p.stem for p in (REPO / "examples").glob("*.py"))


def test_every_script_but_multichip_aot_is_ported():
    ported = {p.stem for p in (REPO / "fftisdf_tpu_torch" / "examples")
              .glob("*.py") if not p.stem.startswith("_")}
    assert set(SCRIPTS) - ported == NOT_PORTED
    assert ported <= set(SCRIPTS)


@pytest.mark.parametrize("name", [s for s in SCRIPTS if s not in NOT_PORTED])
def test_flags_match_the_jax_script(name):
    jax_flags = _script_flags(REPO / "examples" / f"{name}.py")
    mod = importlib.import_module(f"fftisdf_tpu_torch.examples.{name}")
    # every entry point runs on the card unless asked for the CPU
    want = {"--device": "cuda"}
    for flag, default in jax_flags.items():
        if flag == "--tpu":
            continue
        flag = RENAMED.get((name, flag), flag)
        want[flag] = NEW_DEFAULTS.get((name, flag), default)
    got = _port_flags(mod.build_parser())
    dtype = got.pop("--dtype", None)
    assert got == want
    # a float32 route wherever the JAX script could run on the TPU: with
    # --tpu, or by default with --cpu to leave it (nio_northstar)
    tpu = "--tpu" in jax_flags or "--cpu" in jax_flags
    assert dtype == ("float64" if tpu else None)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No fallback: without CUDA and without --device cpu a driver raises
    before it computes anything."""
    from fftisdf_tpu_torch.examples import diamond_isdf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diamond_isdf.main([])


def test_masks_hook_holds_the_examples_parent_mesh():
    """A recorded mask is taken only on the example's own parent mesh or,
    for an 'auto' mesh, on one that selection densifies it to: an example
    whose pool differs from the JAX script's fails."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.isdf.kpoint import densify_mesh
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=30.0)
    kpts = cell.get_kpts([1, 1, 1])
    fixed = FFTISDF(cell, kpts, m0=(9, 9, 9), verbose=0, device="cpu")
    with pytest.raises(AssertionError, match="parent mesh"):
        _common.build(fixed, [{"m0": [11, 11, 11], "mask": [0]}])
    auto = FFTISDF(cell, kpts, c0=5.0, verbose=0, device="cpu")
    twice = densify_mesh(densify_mesh(auto.m0))
    with pytest.raises(AssertionError, match="parent mesh"):
        _common.build(auto, [{"m0": list(densify_mesh(twice)),
                              "mask": [0]}])
    df = _common.build(auto, [{"m0": list(twice), "mask": list(range(8))}])
    assert df.m0 == twice and df.nip == 8


@pytest.mark.parametrize("key", sorted(RECORD))
def test_record_prints_every_gate(key):
    """Each JAX record (those phase 15 holds on the card too) prints every
    gated key its arguments print, parsed by the port module's patterns;
    held to itself every row passes, and against a run that printed
    nothing every row fails."""
    rec = RECORD[key]
    mod = importlib.import_module(
        f"fftisdf_tpu_torch.examples.{Path(rec['script']).stem}")
    ref = _common.numbers(mod, rec["stdout"] + rec.get("stderr", ""))
    gates = _common.gates(mod, rec["args"])
    assert gates and not [k for k in gates if not ref.get(k)]
    assert all(ok for *_, ok in _common.compare(ref, ref, gates))
    assert not any(ok for *_, ok in _common.compare({}, ref, gates))


# (record key, module): the CPU-affordable runs, with the record's
# arguments, within the port's test-time budget; nio_afm_kuhf at its
# defaults, the JAX anchor, runs in tests/test_torch_scf.py::
# test_nio_example_slice_matches_jax, and chip_smoke.py phase 15 holds
# every other record (diamond_ks, diamond_bands, exciton_dispersion
# among them; nio_northstar, whose exact KUHF takes ~10 minutes on the
# CPU) on the card at the same gates
CASES = [
    ("diamond_isdf", "diamond_isdf"),
    ("molecule_in_a_box_one", "molecule_in_a_box"),
    ("thc_demo", "thc_demo"),
    ("cc_spectroscopy", "cc_spectroscopy"),
    ("dmet_demo", "dmet_demo"),
    ("relax_vibrations", "relax_vibrations"),
    ("phonon_elastic", "phonon_elastic"),
]


@pytest.mark.parametrize("key,name", CASES, ids=[c[0] for c in CASES])
def test_example_matches_jax_record(key, name, capsys):
    rec = RECORD[key]
    mod = importlib.import_module(f"fftisdf_tpu_torch.examples.{name}")
    masks = [dict(m) for m in rec["masks"]]
    ours = mod.main(rec["args"] + ["--device", "cpu"], masks=masks)
    printed = capsys.readouterr()    # thc_demo reports through its logger
    assert _common.numbers(mod, printed.out + printed.err) == ours
    assert not masks, "a recorded mask was not used"
    ref = _common.numbers(mod, rec["stdout"] + rec.get("stderr", ""))
    assert not mod.check(ours), mod.check(ours)
    if name == "thc_demo":
        assert not mod.check(ref), "the JAX record misses its own bound"
    rows = _common.compare(ours, ref, _common.gates(mod, rec["args"]))
    assert rows and all(ok for *_, ok in rows), rows
