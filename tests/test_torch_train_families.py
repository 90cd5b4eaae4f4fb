"""Port parity for the train step of every other family ``launch.train``
trains (CPU): FM, Wide&Deep, BERT4Rec, MIND and GraphSAGE (full batch)
at their smoke configs, each built by both packages'
``launch.train.build`` with the reference's weights carried across
(``convert.recsys_params_from_jax``, ``convert.sage_params_from_jax``),
two ``make_train_step`` steps on the same synthetic batches; then
``launch.train.main`` for every architecture.

Tolerances are ``test_torch_train.py``'s: the loss and the global grad
norm of a step within 1e-5 relative; after two steps m and v within
1e-4 x max|leaf| per leaf, each weight within 5e-2 x lr + 1e-6 x |p|
elementwise and the weights' gap within 1e-4 of the update's norm.
"""
import argparse
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jlaunch
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import recsys_params_from_jax, sage_params_from_jax
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import count_params
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

from test_torch_train import PEAK_LR, _np, _opt, _rel, assert_state_close

FAMILIES = ["fm", "wide-deep", "bert4rec", "mind", "graphsage-reddit"]
ARGS = argparse.Namespace(seed=0, batch=6, seq=32, device="cpu")


def test_assigned_archs_match_reference():
    """``configs.ASSIGNED_ARCHS``: every model configuration, the
    retrieval setting left out, in the reference's order."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert len(tconfigs.ASSIGNED_ARCHS) == 10
    assert set(tconfigs.ALL_ARCHS) - set(tconfigs.ASSIGNED_ARCHS) == {
        "mememo"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_steps_match_reference(arch):
    """Both packages' ``build`` at the smoke preset: the same loss on the
    same stream, the port on the reference's weights; two steps."""
    jcfg, jparams, jloss, jdata = jlaunch.build(arch, "smoke", ARGS)
    cfg, _, tloss, tdata = tlaunch.build(arch, "smoke", ARGS)
    params = (sage_params_from_jax(_np(jparams)) if arch.startswith("graph")
              else recsys_params_from_jax(cfg.kind, _np(jparams), cfg))
    jstep = jloop.make_train_step(jloss, _opt(jopt), donate=False)
    tstep = tloop.make_train_step(tloss, _opt(topt))
    js, ts = jopt.adamw_init(jparams), tloop.init_train_state(params)
    for _ in range(2):
        batch, tbatch = next(jdata), next(tdata)
        assert sorted(batch) == sorted(tbatch)
        for k in batch:
            np.testing.assert_array_equal(batch[k], tbatch[k])
        jp0 = jparams
        jparams, js, jm = jstep(jparams, js, batch)
        params, ts, tm = tstep(params, ts, tbatch)
        assert math.isfinite(float(tm["loss"]))
        assert _rel(tm["loss"], jm["loss"]) <= 1e-5
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert_state_close(params, ts, jparams, js, jp0, PEAK_LR)


TRAINED = [a for a in list_archs() if get_config(a).family != "retrieval"]


@pytest.mark.parametrize("arch", TRAINED)
def test_launch_train_main_runs_every_arch(arch):
    """``python -m repro_torch.launch.train --arch A --preset smoke
    --steps 3 --device cpu``: three finite losses, the reference build's
    parameter count."""
    out = tlaunch.main(["--arch", arch, "--preset", "smoke", "--steps", "3",
                        "--batch", "4", "--seq", "16", "--device", "cpu"])
    assert out["device"] == "cpu"
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    _, jparams, _, _ = jlaunch.build(arch, "smoke", argparse.Namespace(
        seed=0, batch=4, seq=16))
    assert out["params"] == sum(int(np.prod(np.shape(a)))
                                for a in jax.tree.leaves(jparams))


def test_launch_train_small_lm_loss_falls():
    """The small preset (4 layers, d_model 256) learns the synthetic
    stream: the last of 12 losses below the first."""
    out = tlaunch.main(["--arch", "llama3-8b", "--preset", "small",
                        "--steps", "12", "--batch", "2", "--seq", "32",
                        "--lr", "3e-3", "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert dataclasses.asdict(tlaunch.small_lm(get_config(
        "llama3-8b").model)) == dataclasses.asdict(jlaunch.small_lm(
            jlaunch.get_config("llama3-8b").model))


@pytest.mark.parametrize("arch", ["fm", "llama3-8b"])
def test_launch_train_ckpt_dir_resumes_as_the_reference(arch, tmp_path,
                                                        monkeypatch):
    """``--ckpt-dir``: ``--steps 4 --ckpt-every 2``, then the same command
    with ``--steps 6`` resumes at step 4 (restored into the live state)
    and, as the reference's, draws its batches from the stream's start;
    both runs' losses within 1e-5 of the reference's ``main`` on the
    same directory layout, the port on the reference's initial weights."""
    from repro_torch.convert import lm_params_from_jax

    build = tlaunch.build

    def ref_weights(arch, preset, args):
        cfg, params, loss, data = build(arch, preset, args)
        _, jparams, _, _ = jlaunch.build(arch, preset, args)
        if arch == "fm":
            params = recsys_params_from_jax("fm", _np(jparams), cfg)
        else:
            params.load_state_dict(lm_params_from_jax(_np(jparams)))
        return cfg, params, loss, data

    histories = []

    def recording_fit(*a, **kw):
        out = jloop.fit(*a, **kw)
        histories.append(out[2])
        return out

    monkeypatch.setattr(tlaunch, "build", ref_weights)
    monkeypatch.setattr(jlaunch, "fit", recording_fit)
    for steps in ("4", "6"):
        argv = ["--arch", arch, "--preset", "smoke", "--steps", steps,
                "--batch", "4", "--seq", "16", "--ckpt-every", "2"]
        got = tlaunch.main(argv + ["--device", "cpu", "--ckpt-dir",
                                   str(tmp_path / "port")])
        monkeypatch.setattr("sys.argv", ["train"] + argv + [
            "--ckpt-dir", str(tmp_path / "ref")])
        jlaunch.main()
        want = histories[-1]
        assert got["start_step"] == (0 if steps == "4" else 4)
        assert [h["step"] for h in got["history"]] == \
            [h["step"] for h in want] == list(range(got["start_step"],
                                                    int(steps)))
        for g, w in zip(got["history"], want):
            assert _rel(g["loss"], w["loss"]) <= 1e-5
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_launch_train_ckpt_dir_raises(tmp_path):
    """``--ckpt-dir`` holding another architecture's checkpoint: the
    resume raises the restore's ``KeyError`` for a leaf the file lacks
    rather than train from a state it did not save."""
    argv = ["--preset", "smoke", "--batch", "4", "--seq", "16",
            "--ckpt-every", "1", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    tlaunch.main(["--arch", "fm", "--steps", "2"] + argv)
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        tlaunch.main(["--arch", "mind", "--steps", "3"] + argv)


def test_launch_train_and_the_step_refuse_a_missing_card(monkeypatch):
    """Without ``--device cpu`` the launcher runs on the card and, with no
    card, raises rather than train on the CPU; a train step runs where
    its parameters are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("llama3-8b", "fm", "graphsage-reddit"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", arch, "--steps", "1"])
    cfg, params, loss, data = tlaunch.build("fm", "smoke", ARGS)
    step = tloop.make_train_step(loss, topt.AdamWConfig())
    _, state, metrics = step(params, topt.adamw_init(params), next(data))
    assert metrics["loss"].device.type == "cpu"
    assert count_params(params) == sum(t.numel() for t in state.m.values())
