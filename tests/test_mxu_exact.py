"""Unit tests for ops/mxu_exact.py — the 3-term bf16 split compensation
for one-hot matrix dots.

On CPU every dot is exact f32, so these tests pin the split's ALGEBRA
(reconstruction, spelling equivalence); tests/test_gpu.py checks on the
card that the split stays exact where a default-precision dot may run in
TF32.
"""
import numpy as np
import jax.numpy as jnp

from softbodysimulation_tpu.ops import mxu_exact


def test_split3_reconstructs_to_one_ulp():
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.concatenate([
        rng.uniform(-100.0, 100.0, 4096),
        rng.uniform(-1e-6, 1e-6, 4096),
        [0.0, 1.0, -1.0, np.pi, 1e20, -1e-20],
    ]).astype(np.float32))
    hi, mid, lo = mxu_exact.split3(x)
    rec = (hi.astype(jnp.float32) + mid.astype(jnp.float32)
           + lo.astype(jnp.float32))
    err = np.abs(np.asarray(rec - x))
    tol = np.maximum(np.abs(np.asarray(x)), 1e-30) * 2 ** -22
    assert (err <= tol).all()


def test_split3_parts_exact_residuals():
    # each residual subtraction must be exact: hi + r1 == x bitwise
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-3.0, 3.0, 1024).astype(np.float32))
    hi, mid, lo = mxu_exact.split3(x)
    r1 = x - hi.astype(jnp.float32)
    assert np.array_equal(np.asarray(hi.astype(jnp.float32) + r1),
                          np.asarray(x))
    r2 = r1 - mid.astype(jnp.float32)
    assert np.array_equal(np.asarray(mid.astype(jnp.float32) + r2),
                          np.asarray(r1))


def _signed_onehot(w, s, rng):
    ia = rng.integers(0, w, s)
    ib = rng.integers(0, w, s)
    g = np.zeros((w, s), np.float32)
    g[ib, np.arange(s)] += 1.0
    g[ia, np.arange(s)] -= 1.0
    return jnp.asarray(g, jnp.bfloat16), ia, ib


def test_dot_oh_matches_reference_gather():
    rng = np.random.default_rng(2)
    w, s = 128, 96
    win = rng.uniform(-2.0, 2.0, (3, w)).astype(np.float32)
    g, ia, ib = _signed_onehot(w, s, rng)
    want = win[:, ib] - win[:, ia]
    got = mxu_exact.dot_oh(jnp.asarray(win), g, (((1,), (0,)), ((), ())))
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-6)


def test_stacked_and_three_dot_spellings_bitwise_equal():
    rng = np.random.default_rng(3)
    w, s = 128, 96
    win = jnp.asarray(rng.uniform(-2.0, 2.0, (3, w)).astype(np.float32))
    g, _, _ = _signed_onehot(w, s, rng)
    dims = (((1,), (0,)), ((), ()))
    three = mxu_exact.dot_oh(win, g, dims)
    stacked = mxu_exact.dot_oh(win, g, dims, stack_axis=0)
    assert np.array_equal(np.asarray(three), np.asarray(stacked))


def test_dot_oh_rhs_split_batched_stacked():
    rng = np.random.default_rng(4)
    k, w, s, c = 3, 64, 32, 4
    oh = np.zeros((k, s, w), np.float32)
    idx = rng.integers(0, w, (k, s))
    for kk in range(k):
        oh[kk, np.arange(s), idx[kk]] = 1.0
    data = rng.uniform(-5.0, 5.0, (k, w, c)).astype(np.float32)
    want = np.take_along_axis(data, idx[..., None], axis=1)
    dims = (((2,), (1,)), ((0,), (0,)))
    for kwargs in ({}, {"stack_axis": 2}):
        got = mxu_exact.dot_oh(jnp.asarray(oh, jnp.bfloat16),
                               jnp.asarray(data), dims, split="rhs",
                               **kwargs)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)
