"""K1 (the selection pair gram) in the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; it is held against
the JAX package's plain version and its Pallas kernel in interpret mode, on
the shapes of tests/test_pallas_ops.py.  The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_gpu.py.

Tolerances: 2e-5 * scale in complex64 (the Pallas test's bound, f32
accumulation over K <= 640), 1e-12 * scale in complex128 (f64 roundoff of
a K-term sum).

The complex64 kernel's arithmetic, 3xTF32 (each float32 operand split into
two TF32 halves, three products accumulated in float32), is emulated here
and held against the JAX package's complex128 gram at that tolerance;
single-pass TF32 misses it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.ops.pallas_gram import (HAVE_PALLAS, pair_gram_sq as jax_pgs,
                                         pair_gram_sq_reference as jax_ref)
from fftisdf_tpu_torch.ops import pair_gram

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


def _tf32(a):
    """cvt.rna.tf32.f32 on a float32 tensor: the mantissa rounded to 10
    bits, ties away from zero (the low 13 bits cleared)."""
    return ((a.view(torch.int32) + (1 << 12)) & -(1 << 13)).view(
        torch.float32)


def _gram_tf32(x, passes, square):
    """The gram of the complex64 kernel's arithmetic, from numpy complex64
    x: each real product from TF32 halves (big = tf32(a), small =
    tf32(a - big)) accumulated in float32, as small.big + big.small +
    big.big (passes=3) or big.big alone (single-pass TF32)."""
    nk, ng, nao = x.shape
    xt = torch.from_numpy(x).permute(1, 0, 2).reshape(ng, nk * nao)
    halves = {}
    for name, part in (("r", xt.real.contiguous()),
                       ("i", xt.imag.contiguous())):
        big = _tf32(part)
        halves[name] = (big, _tf32(part - big))

    def prod(a, b):
        (a_big, a_small), (b_big, b_small) = halves[a], halves[b]
        if passes == 1:
            return a_big @ b_big.T
        return a_small @ b_big.T + a_big @ b_small.T + a_big @ b_big.T

    re = prod("r", "r") + prod("i", "i")
    im = prod("r", "i") - prod("i", "r")
    out = (re * re + im * im) / nk**2
    return (out * out if square else out).numpy()


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(64, 200, 26)])
def test_3xtf32_gram_matches_jax_complex128(shape, square):
    x = _x(shape, np.complex64)
    ref = np.asarray(jax_ref(jnp.asarray(x.astype(np.complex128)),
                             square=square))
    out = _gram_tf32(x, 3, square)
    scale = abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=2e-5 * scale, rtol=0)


def test_single_pass_tf32_misses_tolerance():
    """The measurement behind the rule against plain TF32: at the slice's
    width its gram misses 2e-5 * scale (measured 5e-5)."""
    x = _x((64, 200, 26), np.complex64)
    ref = np.asarray(jax_ref(jnp.asarray(x.astype(np.complex128)),
                             square=False))
    err = abs(_gram_tf32(x, 1, False) - ref).max()
    assert err > 2e-5 * abs(ref).max()


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
