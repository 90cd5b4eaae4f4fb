"""Port parity for ``models/encoder.py`` and the ``models/common.py``
helpers it uses (CPU) against ``repro`` on seeded numpy inputs and the
reference's own weights (``convert.encoder_params_from_jax``).

Tolerances: fp32 outputs within rtol = atol = 1e-5 (the two frameworks
sum in different orders); at bf16 compute, the hidden states within 2
bf16 steps of their scale (2 x 2^-8 x max|value|): both round the same
fp32 sums to bf16 after every product, but the attention's exp and sums
run in another order, and a value that lands one step apart there
carries through the residual stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import encoder as jenc
from repro_torch.convert import encoder_params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import encoder as tenc

CFG = dict(vocab=50, d_model=16, n_blocks=2, n_heads=2, d_ff=32, max_len=12)
B, S = 3, 10


def _models(pool: str, seed: int = 0):
    jcfg = jenc.EncoderConfig(**CFG, pool=pool)
    params = jax.tree.map(np.asarray,
                          jenc.init_encoder(jax.random.PRNGKey(seed), jcfg))
    # non-trivial norms and biases, so that every parameter is exercised
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    tcfg = tenc.EncoderConfig(**dataclasses.asdict(jcfg))
    model = tenc.Encoder(tcfg, device="cpu")
    model.load_state_dict(encoder_params_from_jax(params))
    return jcfg, params, tcfg, model.requires_grad_(False)


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab"], size=(B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array([[S], [4], [1]])).astype(np.float32)
    return tokens, mask


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 384)])
def test_layer_norm_and_l2_normalize_match_reference(shape):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=shape) + 1.0).astype(np.float32)
    g = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    for eps in (1e-5, 1e-12):
        np.testing.assert_allclose(
            tcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), eps).numpy(),
            np.asarray(jcommon.layer_norm(x, g, b, eps)), rtol=1e-5,
            atol=1e-5)
    x[0] = 0.0          # the eps sits under the maximum: a zero row stays 0
    np.testing.assert_allclose(
        tcommon.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.l2_normalize(x)), rtol=1e-5, atol=1e-5)
    assert not tcommon.l2_normalize(torch.from_numpy(x))[0].any()


@pytest.mark.parametrize("pool,masked", [("mean", False), ("mean", True),
                                         ("cls", False), ("none", False)])
def test_encoder_forward_matches_reference(pool, masked):
    jcfg, params, tcfg, model = _models(pool)
    tokens, mask = _inputs()
    want = jenc.encoder_forward(params, jcfg, jnp.asarray(tokens),
                                jnp.asarray(mask) if masked else None,
                                dtype=jnp.float32)
    got = tenc.encoder_forward(model, tcfg, torch.from_numpy(tokens),
                               torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_encoder_forward_bf16_matches_reference():
    jcfg, params, tcfg, model = _models("none")
    tokens, _ = _inputs(2)
    want = np.asarray(jenc.encoder_forward(params, jcfg, jnp.asarray(tokens),
                                           dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = tenc.encoder_forward(model, tcfg, torch.from_numpy(tokens),
                               dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    tol = 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_init_encoder_scheme():
    """The reference's initialisation, from a seeded generator: unit
    gains, zero biases, N(0, 0.02) matrices and (2L)^-1/2-scaled output
    projections; the same seed draws the same weights."""
    cfg = tenc.EncoderConfig(vocab=300, d_model=64, n_blocks=2, n_heads=2,
                             d_ff=256, max_len=20)
    a = tenc.init_encoder(cfg, seed=3, device="cpu")
    b = tenc.init_encoder(cfg, seed=3, device="cpu")
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    lay = a.layers
    assert bool((lay["ln1_g"] == 1).all()) and not lay["b1"].any()
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    assert abs(lay["wo"].std().item() - 0.01) < 1e-3
    assert tcommon.count_params(a) == jcommon.count_params(
        jenc.init_encoder(jax.random.PRNGKey(0), jenc.EncoderConfig(
            **dataclasses.asdict(cfg))))
