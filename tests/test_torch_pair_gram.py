"""K1 (the selection pair gram) in the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; it is held against
the JAX package's plain version and its Pallas kernel in interpret mode, on
the shapes of tests/test_pallas_ops.py.  The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_gpu.py.

Tolerances: 2e-5 * scale in complex64 (the Pallas test's bound, f32
accumulation over K <= 640), 1e-12 * scale in complex128 (f64 roundoff of
a K-term sum).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.ops.pallas_gram import (HAVE_PALLAS, pair_gram_sq as jax_pgs,
                                         pair_gram_sq_reference as jax_ref)
from fftisdf_tpu_torch.ops import pair_gram
from torch_test_threads import two_torch_threads  # noqa: F401

SHAPES = [(1, 64, 5), (3, 100, 7), (2, 300, 4), (16, 96, 40)]
TOL = {np.complex64: 2e-5, np.complex128: 1e-12}


def _x(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_reference(shape, square, dtype):
    x = _x(shape, dtype)
    ref = np.asarray(jax_ref(jnp.asarray(x), square=square))
    out = pair_gram.pair_gram_sq_reference(torch.from_numpy(x),
                                           square=square).numpy()
    assert out.dtype == ref.dtype
    scale = max(abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype] * scale, rtol=0)


@pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_interpret(shape, square):
    x = _x(shape, np.complex64)
    ref = np.asarray(jax_pgs(jnp.asarray(x), square=square, tile=64,
                             interpret=True))
    out = pair_gram.pair_gram_sq_reference(torch.from_numpy(x),
                                           square=square).numpy()
    scale = max(abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, atol=2e-5 * scale, rtol=0)


def test_cpu_wrapper_takes_plain_version():
    x = torch.from_numpy(_x((3, 50, 4), np.complex128))
    before = pair_gram.pair_gram_sq.launches
    out = pair_gram.pair_gram_sq(x, square=False)
    assert pair_gram.pair_gram_sq.launches == before
    torch.testing.assert_close(
        out, pair_gram.pair_gram_sq_reference(x, square=False), rtol=0,
        atol=0)
    # (ng, nao) input is promoted to one k-point
    torch.testing.assert_close(pair_gram.pair_gram_sq(x[0], square=True),
                               pair_gram.pair_gram_sq_reference(x[:1]),
                               rtol=0, atol=0)


def test_wrapper_rejects_real_input():
    with pytest.raises(TypeError):
        pair_gram.pair_gram_sq(torch.zeros((2, 8, 3), dtype=torch.float64))
