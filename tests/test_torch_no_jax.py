"""The PyTorch port runs end to end in a process where neither JAX nor the
JAX package can be imported (the GPU machine has no JAX, and the port keeps
its own copy of every host module it needs): cell -> build -> get_jk (with
exxdiv='ewald') and an ERI -> two SCF cycles of the host and of the
device-resident loop, the exact plane-wave oracle, and the build's other
ways (float32 with either selection route, m0='auto', an eigh-family
solver, omega, a truncated kernel, a saved state), on a small He2 cell,
on the CPU, with a ``sys.meta_path`` finder
that refuses ``jax``, ``jaxlib`` and ``fftisdf_tpu`` (exactly that package,
not ``fftisdf_tpu_torch``); none of them may reach ``sys.modules``."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
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

    import numpy as np
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRHF, DeviceKRHF, PWDF

    cell = Cell(a=np.diag([5.0, 5.0, 7.0]),
                atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                basis="sto-3g", pseudo=None, mesh=np.array([11, 11, 15]),
                unit="bohr", precision=1e-10).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0,
                 device="cpu").build()
    vj, vk = df.get_jk(np.stack([np.eye(2, dtype=complex)] * 2))
    assert vj.shape == (2, 2, 2) and bool(vk.isfinite().all())
    dm = np.stack([np.eye(2, dtype=complex)] * 2)
    _, vk_e = df.get_jk(dm, exxdiv="ewald")
    assert bool(vk_e.isfinite().all())
    assert df.get_eri((0, 1, 1, 0)).shape == (2, 2, 2, 2)
    vj_x, vk_x = PWDF(cell, kpts, device="cpu").get_jk(dm, exxdiv="ewald")
    assert vj_x.shape == (2, 2, 2) and bool(vk_x.isfinite().all())
    mf = KRHF(cell, kpts, df, max_cycle=2, verbose=0, device="cpu")
    e = mf.kernel()
    assert np.isfinite(e) and mf.cycles == 2
    mf = DeviceKRHF(cell, kpts, df, max_cycle=2, verbose=0, device="cpu")
    assert np.isfinite(mf.kernel()) and mf.cycles == 2

    import tempfile, warnings
    import torch
    warnings.simplefilter("ignore")
    f32 = torch.float32
    for kw in (dict(dtype=f32), dict(dtype=f32, select_host_f64=False),
               dict(solver="lstsq"), dict(use_trs=False, validate=True),
               dict(m0="auto", m0_floor=(5, 5, 7), select_keep=1e-9)):
        kw.setdefault("m0", (7, 7, 9))
        d = FFTISDF(cell, kpts, c0=8.0, verbose=0, device="cpu", **kw).build()
        vj2, vk2 = d.get_jk(dm)
        assert float((vj2 - vj).abs().max()) < 1e-3, kw
    d32 = FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0, dtype=f32,
                  device="cpu").build()
    mf = DeviceKRHF(cell, kpts, d32, dtype=f32, max_cycle=2, verbose=0,
                    device="cpu")
    assert np.isfinite(mf.kernel()) and mf.ovlp_cutoff == 2e-6
    vj_o, vk_o = df.get_jk(dm, omega=0.4)
    vj_p, vk_p = PWDF(cell, kpts, device="cpu").get_jk(dm, omega=0.4)
    assert float((vk_o - vk_p).abs().max()) < 1e-3
    dt = FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0, trunc="2d",
                 device="cpu").build()
    vj_t, vk_t = dt.get_jk(dm)
    vj_q, vk_q = PWDF(cell, kpts, trunc="2d", device="cpu").get_jk(dm)
    assert float((vj_t - vj_q).abs().max()) < 1e-3
    with tempfile.TemporaryDirectory() as tmp:
        dt.save(tmp + "/state.npz")
        dl = FFTISDF.load(tmp + "/state.npz", cell, kpts, device="cpu")
    assert dl.trunc == dt.trunc
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    assert "fftisdf_tpu_torch.native" in sys.modules
    print("OK", e)
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")
