"""Port parity for ``train/fault_tolerance.py`` (CPU): ``run_resilient``
and ``StragglerWatchdog`` against ``repro.train.fault_tolerance`` on the
reference's smoke setup (the llama smoke LM, ``AdamWConfig(lr=1e-3)``,
``lm_batches(vocab, 8, 33, seed=0, start_step=s)``), the port starting
from the reference's initial weights (``convert.lm_params_from_jax``).

Tolerances: a run with injected failures equals the port's failure-free
run bit for bit (every loss, the final weights, m and v); the port's
losses within 1e-4 relative of the reference's ``run_resilient`` (fp32
sums in another order, compounded over 12 steps); the watchdog's events
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.data.synthetic import lm_batches as jlm_batches
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.models.common import named_tensors
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.checkpoint import CheckpointManager, tree_leaves

STEPS, EVERY = 12, 5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's smoke setup: its ``run_resilient`` with a failure
    at step 7, the port's step, batches and initial weights, and the
    port's failure-free run."""
    jcfg = jget_smoke_config("llama3-8b")
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    jstep = jloop.make_train_step(
        lambda p, tokens, labels: jtf.lm_loss(p, jcfg, tokens, labels,
                                              dtype=jnp.float32),
        jopt.AdamWConfig(lr=1e-3), donate=False)
    d = tmp_path_factory.mktemp("ft")
    _, _, jinfo = jft.run_resilient(
        jparams, jstep,
        lambda s: next(jlm_batches(jcfg.vocab, 8, 33, seed=0, start_step=s)),
        steps=STEPS, ckpt=jckpt.CheckpointManager(str(d / "ref")),
        ckpt_every=EVERY, fail_at=[7])
    cfg = get_smoke_config("llama3-8b")
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray,
                                                          jparams)))
    model.requires_grad_(False)
    step = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels),
        topt.AdamWConfig(lr=1e-3))

    def batch_fn(s):
        return next(lm_batches(cfg.vocab, 8, 33, seed=0, start_step=s))

    clean = run(model, step, batch_fn, d / "clean", STEPS)
    return {"ref": jinfo, "model": model, "step": step, "batch_fn": batch_fn,
            "clean": clean, "dir": d}


def run(model, step, batch_fn, d, steps, every=EVERY, **kw):
    ckpt = CheckpointManager(str(d), keep=3,
                             async_save=kw.pop("async_save", False))
    params, state, info = tft.run_resilient(
        model, step, batch_fn, steps=steps, ckpt=ckpt, ckpt_every=every,
        **kw)
    ckpt.wait()
    info["state"] = {k: t.detach().clone() for k, t in tree_leaves(
        {"params": params, "opt": state})}
    return info


def assert_bit_for_bit(got, want):
    assert sorted(got["losses"]) == sorted(want["losses"])
    for s, loss in want["losses"].items():
        assert got["losses"][s] == loss, s
    assert sorted(got["state"]) == sorted(want["state"])
    for k, t in want["state"].items():
        assert torch.equal(got["state"][k], t), k


def test_resilient_run_matches_reference(setup):
    """The reference's ``test_resilient_restart_is_exact`` on the port: a
    failure at step 7 (restored from step 5) equals the failure-free
    run bit for bit, and every loss is the reference's (1e-4)."""
    got = run(setup["model"], setup["step"], setup["batch_fn"],
              setup["dir"] / "fail7", STEPS, fail_at=[7])
    assert got["restarts"] == setup["ref"]["restarts"] == 1
    assert setup["clean"]["restarts"] == 0
    assert_bit_for_bit(got, setup["clean"])
    for s, want in setup["ref"]["losses"].items():
        assert abs(got["losses"][s] - want) <= 1e-4 * abs(want), s


def test_two_failures_async_with_watchdog(setup):
    """``examples/fault_tolerant_training.py``'s mechanisms on the smoke
    setup: async saves every 5 steps and a watchdog; a failure at 3,
    before the first checkpoint, restarts from scratch (new tensors from
    the host snapshot: the caller's module is never trained), one at 11
    restores step 10; two restarts, bit for bit with the failure-free
    run, the last save at step 12."""
    model = setup["model"]
    before = {n: p.clone() for n, p in named_tensors(model)}
    wd = tft.StragglerWatchdog(min_samples=5, factor=4.0)
    d = setup["dir"] / "two"
    got = run(model, setup["step"], setup["batch_fn"], d, STEPS,
              fail_at=[3, 11], async_save=True, watchdog=wd)
    assert got["restarts"] == 2
    assert got["stragglers"] is wd.events
    assert len(wd.times) == STEPS + 3 + 1     # steps 0-2 and 10 replayed
    assert_bit_for_bit(got, setup["clean"])
    assert CheckpointManager(str(d)).all_steps() == [5, 10, 12]
    for n, p in named_tensors(model):
        assert torch.equal(p, before[n]), n


class _TornState(dict):
    """An ``OptState.m`` that raises on the first read of ``fail_key``:
    ``adamw_update`` has then updated the weights and m of the leaves
    before it, in place."""

    def __init__(self, m, fail_key):
        super().__init__(m)
        self.fail_key = fail_key

    def __getitem__(self, key):
        if key == self.fail_key:
            raise RuntimeError("device lost mid-update")
        return super().__getitem__(key)


def test_torn_in_place_step_is_repaired_by_the_restore(setup):
    """A step that fails between two leaves' updates leaves a torn state
    (half the weights and m stepped); the restore from step 5 repairs
    it and the run equals the failure-free one bit for bit."""
    step, torn = setup["step"], {}

    def torn_step(params, state, batch):
        if int(state.step) == 7 and not torn:
            names = list(state.m)
            torn["key"] = names[len(names) // 2]
            torn["first"] = named_tensors(params)[0][1].clone()
            torn["params"] = params
            state = topt.OptState(_TornState(state.m, torn["key"]), state.v,
                                  state.step)
        return step(params, state, batch)

    got = run(setup["model"], torn_step, setup["batch_fn"],
              setup["dir"] / "torn", STEPS)
    assert got["restarts"] == 1
    # the failed step did update the leaves before the torn one in place
    assert not torch.equal(named_tensors(torn["params"])[0][1],
                           torn["first"])
    assert_bit_for_bit(got, setup["clean"])


def test_max_restarts_exceeded_raises(setup, tmp_path):
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        run(setup["model"], setup["step"], setup["batch_fn"], tmp_path, 6,
            fail_at=[1, 2, 3], max_restarts=2)


def test_resilient_dict_tree(tmp_path):
    """A recsys tree (fm's smoke config, a dict of tensors) through two
    failures, one before the first checkpoint: bit for bit."""
    import argparse
    args = argparse.Namespace(seed=0, batch=8, seq=16, device="cpu")
    _, params, loss, data = tlaunch.build("fm", "smoke", args)
    batches = [next(data) for _ in range(8)]
    step = tloop.make_train_step(loss, topt.AdamWConfig(lr=1e-2))
    clean = run(params, step, batches.__getitem__, tmp_path / "a", 8, every=3)
    got = run(params, step, batches.__getitem__, tmp_path / "b", 8, every=3,
              fail_at=[1, 5])
    assert got["restarts"] == 2
    assert_bit_for_bit(got, clean)


def test_watchdog_events_match_reference():
    """One sequence of step times through both watchdogs: the same
    flags and events (step, seconds, p95)."""
    rng = np.random.default_rng(3)
    times = list(rng.uniform(0.010, 0.012, 40))
    for i in (12, 25, 26, 39):
        times[i] *= 5.0
    jw = jft.StragglerWatchdog(window=20, factor=3.0, min_samples=10)
    tw = tft.StragglerWatchdog(window=20, factor=3.0, min_samples=10)
    hooked = []
    tw.on_straggler = hooked.append
    for i, t in enumerate(times):
        assert tw.observe(i, t) == jw.observe(i, t), i
    assert [(e.step, e.seconds, e.p95) for e in tw.events] == \
        [(e.step, e.seconds, e.p95) for e in jw.events]
    assert tw.events and tw.events[0].step == 12 and hooked == tw.events
