"""Port parity for ``embedding_bag`` (CPU): the port's ``ops.embedding_bag``
(its plain version, ``ref.embedding_bag_ref``, on CPU tensors) against the
JAX package's jnp oracle and its Pallas kernel in interpret mode
(``tests/test_kernels.py`` runs the kernel that way), on the same numpy
inputs.

Tolerances: against the jnp oracle rtol 1e-5 / atol 1e-6 for f32 and bf16
tables alike (bf16 rows widen to fp32 exactly, so the two differ only in
summation order); against the interpreted Pallas kernel the reference
test's 1e-4. Integer-valued tables with 0/1 weights sum exactly in fp32,
so there every result must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.core import dispatch
from repro_torch.kernels import ops as tops

# (R, E, B, L, table dtype): the reference test's shapes, then E 10
# (FM's width: scalar row loads on the card) and E 64 at MIND's L 50
SHAPES = [(100, 32, 12, 6, "f32"), (1000, 64, 8, 4, "f32"),
          (50, 16, 6, 3, "bf16"), (200, 10, 9, 5, "f32"),
          (300, 64, 7, 50, "bf16")]


def _tables(x: np.ndarray, dtype: str):
    """fp32 rows -> (jax table, torch table) holding the same values."""
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    jt = jnp.asarray(x, jnp.bfloat16)
    exact = np.array(jt.astype(jnp.float32))       # bf16 values, in fp32
    return jt, torch.from_numpy(exact).to(torch.bfloat16)


@pytest.mark.parametrize("r,e,b,l,dtype", SHAPES)
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax_and_pallas(r, e, b, l, dtype, combine,
                                              weighted):
    rng = np.random.default_rng(r + e + b + l)
    x = rng.normal(size=(r, e)).astype(np.float32)
    ids = rng.integers(0, r, size=(b, l)).astype(np.int32)
    w = None
    if weighted:
        w = rng.random((b, l)).astype(np.float32)
        w[0] = 0.0                          # a bag whose weights are all 0
    jt, tt = _tables(x, dtype)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    want = np.asarray(jref.embedding_bag_ref(jt, jnp.asarray(ids), jw,
                                             combine=combine))
    pallas = np.asarray(embedding_bag_pallas(jt, jnp.asarray(ids), jw,
                                             combine=combine,
                                             interpret=True))
    dispatch.reset()
    got = tops.embedding_bag(tt, torch.from_numpy(ids), tw, combine=combine)
    assert dispatch.get("kernel.embedding_bag") == 0    # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (b, e)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
    if weighted:
        assert not got[0].any()             # 0-weight bag: 0 for sum and mean


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_integer_rows_exact(dtype, combine):
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, size=(64, 24)).astype(np.float32)
    ids = rng.integers(0, 64, size=(10, 7)).astype(np.int32)
    w = (rng.random((10, 7)) < 0.6).astype(np.float32)     # 0/1 mask
    jt, tt = _tables(x, dtype)
    want = np.asarray(jref.embedding_bag_ref(jt, jnp.asarray(ids),
                                             jnp.asarray(w), combine=combine))
    pallas = np.asarray(embedding_bag_pallas(jt, jnp.asarray(ids),
                                             jnp.asarray(w), combine=combine,
                                             interpret=True))
    got = tops.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(w),
                             combine=combine).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_embedding_bag_rejects_bad_input():
    t = torch.zeros(4, 3)
    ids = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="combine"):
        tops.embedding_bag(t, ids, combine="max")
    with pytest.raises(IndexError):           # the plain version's gather
        tops.embedding_bag(t, torch.full((2, 2), 9, dtype=torch.int32))
