"""Port parity for ``data/synthetic.py`` and the sampler's ``make_csr``:
the port keeps its own numpy copy, so every batch (the first two of each
generator) and every graph array must equal the reference's bit for bit."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn

GENERATORS = {
    "lm": ("lm_batches", (97, 3, 9), {"seed": 3, "start_step": 2,
                                      "dp_rank": 1, "dp_size": 2}),
    "ctr": ("ctr_batches", (5, 64, 3, 7), {"seed": 1}),
    "seq_rec": ("seq_rec_batches", (500, 10, 4), {"seed": 2, "n_neg": 5}),
    "masked_item": ("masked_item_batches", (300, 20, 4),
                    {"seed": 4, "start_step": 5}),
    "molecule": ("molecule_batches", (6, 12, 5, 2), {"seed": 6}),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_batches_match_reference(name):
    fn, args, kw = GENERATORS[name]
    want = list(itertools.islice(getattr(jsyn, fn)(*args, **kw), 2))
    got = list(itertools.islice(getattr(tsyn, fn)(*args, **kw), 2))
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_graph_matches_reference(seed):
    want = jsyn.make_graph(500, 6, 12, 5, seed=seed)
    got = tsyn.make_graph(500, 6, 12, 5, seed=seed)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        assert g.dtype == w.dtype, field.name
        np.testing.assert_array_equal(g, w, err_msg=field.name)


def test_make_corpus_matches_reference():
    np.testing.assert_array_equal(tsyn.make_corpus(300, 16, seed=2),
                                  jsyn.make_corpus(300, 16, seed=2))
