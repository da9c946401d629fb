"""CPU tests of the benchmark's harness: the spec and the files it names,
the yardstick's arithmetic, the seeded inputs, the result line, the
guards.  ``python -m pytest benchmark/tests -q`` from the repo root."""
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import device as dev_mod
from benchmark.harness import roofline, spec as spec_mod
from benchmark.harness.geometry import geometry

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec_mod.load_spec()


def test_spec_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {m["name"] for m in SPEC["end_to_end"]} == {"job_s", "setup_s"}


def test_files_found_by_name():
    for w in SPEC["workloads"]:
        cfg = spec_mod.load_config(SPEC, w["config"])
        assert cfg["name"] == w["config"] and cfg["limits"]
        mix = spec_mod.load_traffic(w["traffic"])
        e2e = [m["name"] for m in spec_mod.end_to_end_metrics(SPEC,
                                                               w["name"])]
        assert "setup_s" in e2e and mix["end_to_end"] in e2e
        layer = spec_mod.per_layer_metrics(SPEC, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(spec_mod.metric_reader(m["name"]).read)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("shape,dname,ms", [
    ((64, 3375, 26), "complex128", 1.132),
    ((64, 3375, 62), "complex128", 2.699),
    ((64, 3375, 26), "complex64", 0.460),
    ((64, 3375, 62), "complex64", 1.096)])
def test_k1_bound_matches_perf_table(shape, dname, ms):
    _, sec, by = roofline.k1_bound(shape, dname)
    assert round(1e3 * sec, 3) == ms and by == "operations"


def test_seeded_geometry():
    cfg = spec_mod.load_config(SPEC, "nio_afm_dzvp_k222")
    d = cfg["displacement_bohr"]
    lat0 = np.asarray(cfg["structure"]["lattice_angstrom"]) / 0.52917721092
    frac = np.asarray([f for _, f in cfg["structure"]["atoms_fractional"]])
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 3):
        lat, atoms = geometry(cfg, seed, 3)
        lat2, atoms2 = geometry(cfg, seed, 3)
        xyz = np.array([x for _, x in atoms])
        assert np.array_equal(xyz, np.array([x for _, x in atoms2]))
        assert np.array_equal(lat, lat0) and np.array_equal(lat, lat2)
        dev = np.abs(xyz - frac @ lat0)
        assert dev.max() <= d and dev.max() > 0.1 * d
    a = np.array([x for _, x in geometry(cfg, 5, 0)[1]])
    b = np.array([x for _, x in geometry(cfg, 5, 1)[1]])
    c = np.array([x for _, x in geometry(cfg, 6, 0)[1]])
    assert not np.allclose(a, b) and not np.allclose(a, c)


def test_mix_and_config_reach_the_scf_class():
    """Every key of the configuration's and the mix's ``scf`` blocks but
    the method and the class name is a keyword argument of the SCF
    class."""
    from benchmark.harness.program import scf_kwargs

    cfg = {"scf": {"method": "UHF", "smearing": 0.005, "max_cycle": 80,
                   "init_spin": {"0": 1.0, "-1": -1.0}}}
    mix = {"scf": {"driver": "DeviceKUKS", "xc": "pbe", "max_cycle": 60}}
    kw = scf_kwargs(cfg, mix, torch.float64, 1e-8)
    assert kw == {"smearing": 0.005, "max_cycle": 60, "xc": "pbe",
                  "init_spin": {0: 1.0, -1: -1.0}, "conv_tol": 1e-8,
                  "verbose": 0, "dtype": torch.float64}


def test_every_mix_names_its_reference():
    for f in (ROOT / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        assert (ROOT / "benchmark" / "reference"
                / f"{mix['reference']}.py").is_file()


def test_no_jax_guard():
    mods = {"fftisdf_tpu_torch": 1, "fftisdf_tpu_torch.scf": 1,
            "numpy": 1}
    assert dev_mod.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "fftisdf_tpu.isdf": 1, "jaxlib": 1})
    assert dev_mod.forbidden_modules(mods) == ["fftisdf_tpu", "jax",
                                               "jaxlib"]


def test_finish_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {}}
    monkeypatch.setitem(sys.modules, "fftisdf_tpu", object())
    assert bench_run.finish(result) == 3
    out = capsys.readouterr()
    assert out.out == "" and "fftisdf_tpu" in out.err


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_run.main(["--workload", "nio_dzvp_k222.job", "--seed", "1",
                             "--seconds", "1"])
    assert rc == 2 and buf.getvalue() == ""
    with pytest.raises(dev_mod.NoCard):
        dev_mod.require_cards(1)


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the run exits with an error and prints no result."""
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(tmp_path)],
                   check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(tmp_path)],
                   check=True)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "nio_dzvp_k222.job", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|fftisdf_tpu)"
                     r"(\.|\s|$)", re.M)
    for f in ref.rglob("*.py"):
        assert not pat.search(f.read_text()), f
        assert "fftisdf_tpu_torch" not in f.read_text().replace(
            "``fftisdf_tpu_torch``", ""), f
    code = ("import sys; import benchmark.reference.uhf; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = json.loads(out.replace("'", '"'))
    assert not {"fftisdf_tpu_torch", "fftisdf_tpu", "jax"} & set(loaded)


@pytest.mark.gpu
def test_card_run_prints_a_correct_result(card):
    """One short run of the first cell on the card."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "2718",
                        "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and res["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
