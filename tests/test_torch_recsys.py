"""Port parity for ``models/recsys.py`` (CPU) against ``repro`` on the
smoke configs, the reference's own weights
(``convert.recsys_params_from_jax``) and the synthetic batches of
``data/synthetic.py`` (equal in both packages).

Tolerances: fp32 forwards, user embeddings and loss values within
rtol = atol = 1e-5; integer outputs (the retrieval ids) exactly.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.flat import FlatIndex as JFlatIndex
from repro.models import recsys as jrs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import recsys_params_from_jax
from repro_torch.core.flat import FlatIndex
from repro_torch.data import synthetic
from repro_torch.models import recsys as trs
from repro_torch.models.common import count_params, tree_tensors

ARCHS = {"fm": "fm", "wide-deep": "wide_deep", "bert4rec": "bert4rec",
         "mind": "mind"}
B = 6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _setup(arch: str, seed: int = 0):
    kind = ARCHS[arch]
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    params = jax.tree.map(np.asarray,
                          jrs.INIT[kind](jax.random.PRNGKey(seed), jcfg))
    return kind, jcfg, params, cfg, recsys_params_from_jax(kind, params, cfg)


def _batch(kind: str, cfg):
    if kind in ("fm", "wide_deep"):
        gen = synthetic.ctr_batches(cfg.n_sparse, cfg.rows_per_field,
                                    cfg.n_dense, B, seed=1)
    elif kind == "bert4rec":
        gen = synthetic.masked_item_batches(cfg.n_items, cfg.seq_len, B,
                                            seed=2)
    else:
        gen = synthetic.seq_rec_batches(cfg.n_items, cfg.seq_len, B, seed=3)
    return next(itertools.islice(gen, 1, None))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _shapes(tree, prefix: str = "") -> dict:
    """{path: shape} of a parameter tree of either package."""
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: tuple(v.shape)
                for k, v in tree.state_dict().items()}
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {path: shape for k, v in items
                for path, shape in _shapes(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tuple(np.shape(tree))}


def _runs(kind, params, cfg, batch, lib, conv):
    """-> {output name: value} of one package's functions on ``batch``."""
    if kind in ("fm", "wide_deep"):
        fwd = getattr(lib, f"{kind}_forward")
        loss = getattr(lib, f"{kind}_loss")
        args = (conv(batch["sparse_ids"]), conv(batch["dense"]))
        return {"forward": fwd(params, cfg, *args),
                "loss": loss(params, cfg, *args, conv(batch["labels"]))}
    if kind == "bert4rec":
        seq = conv(batch["item_seq"])
        pos = np.tile(np.array([[1, 5, 9]], np.int32), (B, 1))
        lab = np.take_along_axis(batch["labels"], pos, axis=1)
        return {"user": lib.bert4rec_user_embedding(params, cfg, seq),
                "scores": lib.bert4rec_scores(params, cfg, seq),
                "loss": lib.bert4rec_loss(params, cfg, seq,
                                          conv(batch["labels"]),
                                          conv(batch["label_mask"])),
                "masked_loss": lib.bert4rec_masked_loss(
                    params, cfg, seq, conv(pos), conv(lab))}
    beh, mask = conv(batch["behavior"]), conv(batch["behavior_mask"])
    return {"user": lib.mind_user_embedding(params, cfg, beh, mask),
            "loss": lib.mind_loss(params, cfg, beh, mask,
                                  conv(batch["target"]), conv(batch["neg"]))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_config_outputs_match_reference(arch):
    kind, jcfg, params, cfg, tparams = _setup(arch)
    batch = _batch(kind, cfg)
    want = _runs(kind, params, jcfg, batch, jrs, jnp.asarray)
    with torch.no_grad():
        got = _runs(kind, tparams, cfg, batch, trs, _t)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_matches_reference_layout(arch):
    """``INIT[kind]`` draws the reference's tree (every shape) from a
    seeded generator, the same draws for the same seed."""
    kind, _, params, cfg, _ = _setup(arch)
    a = trs.INIT[kind](cfg, seed=5, device="cpu")
    b = trs.INIT[kind](cfg, seed=5, device="cpu")
    assert _shapes(a) == _shapes(params)
    assert all(torch.equal(x, y) for x, y in zip(tree_tensors(a),
                                                 tree_tensors(b)))
    assert count_params(a) == sum(int(np.prod(np.shape(x)))
                                  for x in jax.tree.leaves(params))


def test_lookup_gathers_each_fields_row():
    table = torch.arange(3 * 5 * 2, dtype=torch.float32).reshape(3, 5, 2)
    ids = torch.tensor([[0, 4, 2], [1, 0, 3]], dtype=torch.int32)
    out = trs.lookup(table, ids)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jrs.lookup(jnp.asarray(table.numpy()),
                                           jnp.asarray(ids.numpy()))))
    assert torch.equal(out[0, 1], table[1, 4])
    assert torch.equal(trs.lookup(table[..., 0], ids), out[..., 0])


def test_bert4rec_vocab_is_padded_to_256():
    """+mask +pad, then padded to a multiple of 256: 60,002 -> 60,160 at
    the published config, as the reference pads it."""
    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke_config)):
        cfg = get("bert4rec")
        cfg = getattr(cfg, "model", cfg)
        jcfg = jget("bert4rec")
        jcfg = getattr(jcfg, "model", jcfg)
        vocab = trs._bert4rec_enc_cfg(cfg).vocab
        assert vocab == jrs._bert4rec_enc_cfg(jcfg).vocab
        assert vocab % 256 == 0 and vocab - 256 < cfg.n_items + 2 <= vocab
    assert trs._bert4rec_enc_cfg(get_config("bert4rec").model).vocab == 60160


def test_mind_interests_are_identical_and_mask_blind():
    """The routing logits start at zero (the reference's behaviour, kept):
    every interest of a user is the same vector. Masked-out items move
    nothing."""
    kind, jcfg, params, cfg, tparams = _setup("mind")
    batch = _batch(kind, cfg)
    beh, mask = _t(batch["behavior"]), _t(batch["behavior_mask"])
    got = trs.mind_interests(tparams, cfg, beh, mask)
    assert got.shape[1] == cfg.n_interests > 1
    assert torch.equal(got, got[:, :1].expand_as(got))
    want = np.asarray(jrs.mind_interests(params, jcfg, jnp.asarray(beh),
                                         jnp.asarray(mask)))
    np.testing.assert_array_equal(want, want[:, :1].repeat(want.shape[1], 1))
    beh2 = torch.where(mask > 0, beh, (beh + 7) % cfg.n_items)
    _close(trs.mind_interests(tparams, cfg, beh2, mask), got)


@pytest.mark.parametrize("k", [5, 100])
def test_retrieval_cand_routes_through_flat_index(k):
    """retrieval_cand: one user's interests against the item table through
    ``FlatIndex(metric="ip")``, ids equal to the reference's."""
    kind, jcfg, params, cfg, tparams = _setup("mind")
    batch = _batch(kind, cfg)
    beh, mask = batch["behavior"][:1], batch["behavior_mask"][:1]
    interests = trs.mind_user_embedding(tparams, cfg, _t(beh), _t(mask))[0]
    jint = jrs.mind_user_embedding(params, jcfg, jnp.asarray(beh),
                                   jnp.asarray(mask))[0]
    d, i = FlatIndex.build(tparams["items"].numpy(), metric="ip",
                           device="cpu").query(interests.numpy(), k=k)
    jd, ji = JFlatIndex.build(params["items"], metric="ip").query(
        np.asarray(jint), k=k)
    assert tuple(i.shape) == (cfg.n_interests, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(d, jd)
