"""Port parity for ``train/checkpoint.py`` (CPU): ``CheckpointManager``
against ``repro.train.checkpoint`` on the same numpy-seeded trees —
file names, ``__meta__`` bytes, members and keep-last-k GC, the errors,
bf16 leaves, the async snapshot taken before an in-place step, and a
reference checkpoint carried into the port (``convert.tree_from_checkpoint``)
resuming to the reference's resumed losses.

Tolerances: members and restored leaves equal bit for bit; resumed losses
within 1e-5 relative (``test_torch_train.py``'s bound for a step's loss).
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import train_loop as jloop
from repro_torch.convert import (
    lm_params_from_jax,
    opt_state_from_jax,
    tree_from_checkpoint,
)
from repro_torch.data import synthetic
from repro_torch.models import transformer as ttf
from repro_torch.models.common import named_tensors
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

from test_torch_train import _builds, _opt, _rel, jopt


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "nested": {"b": rng.normal(size=4).astype(np.float32),
                       "z": rng.normal(size=(2, 2)).astype(np.float32)},
            "list": [rng.normal(size=3).astype(np.float32),
                     np.float32(rng.normal())]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _jax_tree(seed):
    return _map(jnp.asarray, _arrays(seed))


def _torch_tree(seed):
    return _map(lambda a: torch.from_numpy(np.array(a)), _arrays(seed))


def _members(path):
    with np.load(path, allow_pickle=False) as z:
        return [(k, z[k]) for k in z.files]


def assert_same_files(d_port, d_ref):
    names = sorted(os.listdir(d_port))
    assert names == sorted(os.listdir(d_ref))
    for f in names:
        got, want = _members(os.path.join(d_port, f)), \
            _members(os.path.join(d_ref, f))
        assert [k for k, _ in got] == [k for k, _ in want], f
        for (k, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, (f, k)
            assert a.tobytes() == b.tobytes(), (f, k)


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("keep", [1, 2, 3])
def test_checkpoint_roundtrip_and_gc_match_reference(tmp_path, keep,
                                                     async_save):
    """The reference's ``test_checkpoint_roundtrip_and_gc`` on both
    managers: the same files (names, members, ``__meta__`` bytes) after
    each save, the reference's keep-last-k, the port's restore."""
    port = tckpt.CheckpointManager(str(tmp_path / "port"), keep=keep,
                                   async_save=async_save)
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"), keep=keep,
                                  async_save=async_save)
    for s in (1, 2, 3):
        port.save(s, _torch_tree(s), meta={"tag": "x"})
        ref.save(s, _jax_tree(s), meta={"tag": "x"})
        port.wait()
        ref.wait()
        assert_same_files(port.dir, ref.dir)
    assert port.all_steps() == ref.all_steps() == [1, 2, 3][-keep:]
    assert port.latest_step() == 3
    got, meta = port.restore(_torch_tree(0), step=3)
    want = _torch_tree(3)
    for (k, a), (k2, b) in zip(tckpt.tree_leaves(got),
                               tckpt.tree_leaves(want)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    assert meta == {"step": 3, "tag": "x"}
    assert not [f for f in os.listdir(port.dir) if f.endswith(".tmp.npz")]


def test_keep_zero_keeps_every_step(tmp_path):
    port = tckpt.CheckpointManager(str(tmp_path), keep=0)
    for s in (5, 10, 15):
        port.save(s, _torch_tree(s))
    assert port.all_steps() == [5, 10, 15]
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore({})


def test_a_failed_async_write_raises_at_wait(tmp_path, monkeypatch):
    """The writer thread's error (a full disk) reaches the caller at the
    next ``wait``, and nothing is published."""
    def full_disk(*a, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tckpt.np, "savez", full_disk)
    ckpt = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(1, _torch_tree(1))
    with pytest.raises(OSError, match="No space"):
        ckpt.wait()
    ckpt.wait()                           # raised once
    assert ckpt.all_steps() == []


def test_restore_errors_match_reference(tmp_path):
    """A leaf the file lacks raises ``KeyError``, a shape that differs
    ``ValueError``, with the reference's messages."""
    port = tckpt.CheckpointManager(str(tmp_path / "port"))
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"))
    port.save(1, _torch_tree(1))
    ref.save(1, _jax_tree(1))
    for make, exc in (
            (lambda t: {**t, "extra": t["a"]}, KeyError),
            (lambda t: {**t, "nested": {**t["nested"], "b": t["a"]}},
             ValueError)):
        with pytest.raises(exc) as got:
            port.restore(make(_torch_tree(0)))
        with pytest.raises(exc) as want:
            ref.restore(make(_jax_tree(0)))
        assert str(got.value) == str(want.value)


def test_bf16_and_fp16_leaves_match_reference(tmp_path):
    """numpy has no bfloat16: both write a bf16 leaf's raw bits as a
    2-byte void member (the port names its dtype in the meta), fp16 as
    float16. The port restores the dtypes bit for bit, from its own file
    and from the reference's."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    port_tree = {"h": torch.from_numpy(x).to(torch.bfloat16),
                 "f": torch.from_numpy(x).to(torch.float16)}
    ref_tree = {"h": jnp.asarray(x).astype(jnp.bfloat16),
                "f": jnp.asarray(x).astype(jnp.float16)}
    port = tckpt.CheckpointManager(str(tmp_path / "port"))
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"))
    port.save(1, port_tree)
    ref.save(1, ref_tree)
    got = dict(_members(port._path(1)))
    want = dict(_members(ref._path(1)))
    for k in ("f", "h"):
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    template = {"h": torch.zeros(3, 5, dtype=torch.bfloat16),
                "f": torch.zeros(3, 5, dtype=torch.float16)}
    for d, dtypes in ((port.dir, {"h": "bfloat16"}), (ref.dir, None)):
        state, meta = tckpt.CheckpointManager(d).restore(template)
        assert meta.get("dtypes") == dtypes
        for k, t in port_tree.items():
            assert state[k].dtype == t.dtype and torch.equal(state[k], t), k


def test_leaves_read_straight_from_the_file_equal_np_load(tmp_path):
    """``restore`` reads each member's bytes from its offset in the file
    (``_stored_members``, ``_read_member``): every member of a port file
    and of a reference file (int32, fp32, 0-d, bf16 bits, fp16, the
    meta) equals ``np.load``'s, its CRC-32 checked."""
    port = tckpt.CheckpointManager(str(tmp_path / "port"))
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"))
    x = np.random.default_rng(4).normal(size=(5, 7)).astype(np.float32)
    port.save(1, {**_torch_tree(1), "h": torch.from_numpy(x).to(
        torch.bfloat16), "f": torch.from_numpy(x).to(torch.float16)})
    ref.save(1, {**_jax_tree(1), "h": jnp.asarray(x, jnp.bfloat16)})
    for mgr in (port, ref):
        path = mgr._path(1)
        members = tckpt._stored_members(path)
        with np.load(path) as z:
            assert sorted(members) == sorted(z.files)
            for k, m in members.items():
                got, want = tckpt._read_member(path, k, m), z[k]
                assert got.dtype == want.dtype and got.shape == want.shape, k
                assert got.tobytes() == want.tobytes(), k


def test_a_corrupted_leaf_raises_as_in_the_reference(tmp_path):
    """One flipped byte in a leaf's data: the port's ``restore`` raises
    ``ValueError`` (the CRC-32 check), as the reference's ``np.load``
    raises, and a missing or mismatched leaf raises before any read."""
    port = tckpt.CheckpointManager(str(tmp_path / "port"))
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"))
    port.save(1, _torch_tree(1))
    ref.save(1, _jax_tree(1))
    for mgr in (port, ref):
        path = mgr._path(1)
        m = tckpt._stored_members(path)["nested/z"]
        with open(path, "r+b") as f:
            f.seek(m.offset + 5)
            b = f.read(1)
            f.seek(m.offset + 5)
            f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(ValueError, match="nested/z.*CRC-32"):
        port.restore(_torch_tree(0))
    with pytest.raises(Exception, match="CRC"):
        ref.restore(_jax_tree(0))
    with pytest.raises(ValueError, match="nested/z.*CRC-32"):
        tckpt.CheckpointManager(ref.dir).restore(_torch_tree(0))


@pytest.mark.parametrize("kind", ["compressed", "fortran"])
def test_a_member_np_savez_does_not_write_is_refused(tmp_path, kind):
    """A compressed member or a Fortran-ordered one is not one run of C
    bytes: ``restore`` refuses the file with ``ValueError``."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta = np.frombuffer(b'{"step": 1}', dtype=np.uint8)
    if kind == "compressed":
        np.savez_compressed(mgr._path(1)[:-4], a=a, __meta__=meta)
    else:
        np.savez(mgr._path(1)[:-4], a=np.asfortranarray(a), __meta__=meta)
    with pytest.raises(ValueError, match="'a.npy'"):
        mgr.restore({"a": torch.zeros(2, 3)})


def test_async_save_writes_the_state_before_an_in_place_step(
        tmp_path, monkeypatch):
    """An async save followed at once by a train step (which updates the
    weights, m and v in place) writes the pre-step values: the snapshot
    is taken on the caller's thread. The writer is held back until the
    step has run."""
    _, _, _, model, data = _builds("llama3-8b")
    step = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels), _opt(topt))
    model, state, _ = step(model, topt.adamw_init(model), next(data))
    before = {k: v.detach().clone() for k, v in tckpt.tree_leaves(
        {"params": model, "opt": state})}
    savez, go = np.savez, threading.Event()

    def held_savez(*a, **kw):
        go.wait(timeout=60)
        return savez(*a, **kw)

    monkeypatch.setattr(tckpt.np, "savez", held_savez)
    ckpt = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(1, {"params": model, "opt": state})
    model, state, _ = step(model, state, next(data))
    assert ckpt._pending is not None and ckpt._pending.is_alive()
    go.set()
    got, meta = ckpt.restore({"params": model, "opt": state})
    assert meta == {"step": 1} and ckpt.last_save["bytes"] > 0
    assert int(state.step) == 2 and int(got["opt"].step) == 1
    for k, t in tckpt.tree_leaves(got):
        assert torch.equal(t.detach(), before[k]), k
    moved = [k for k, t in tckpt.tree_leaves({"params": model})
             if not torch.equal(t.detach(), before[k])]
    assert moved                      # the step did change the live state


def test_restore_inplace_and_device(tmp_path):
    """``inplace=True`` copies into the template's own tensors (a module
    keeps its parameters' storage); a plain restore builds a new module
    with the template's ``requires_grad``."""
    _, _, _, model, _ = _builds("llama3-8b")
    state = topt.adamw_init(model)
    ckpt = tckpt.CheckpointManager(str(tmp_path))
    ckpt.save(4, {"params": model, "opt": state})
    fresh = ttf.init_lm(model.cfg, seed=5, device="cpu")
    fresh_state = topt.adamw_init(fresh)
    ptrs = [p.data_ptr() for _, p in named_tensors(fresh)]
    tree, _ = ckpt.restore({"params": fresh, "opt": fresh_state},
                           inplace=True)
    assert tree["params"] is fresh
    assert [p.data_ptr() for _, p in named_tensors(fresh)] == ptrs
    for (n, a), (_, b) in zip(named_tensors(fresh), named_tensors(model)):
        assert torch.equal(a, b), n
    new, _ = ckpt.restore({"params": fresh, "opt": fresh_state},
                          device="cpu")
    assert isinstance(new["params"], ttf.LM) and new["params"] is not fresh
    assert all(not p.requires_grad for p in new["params"].parameters())
    assert all(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in zip(
        named_tensors(new["params"]), named_tensors(fresh)))


def test_reference_checkpoint_resumes_to_reference_losses(tmp_path):
    """The reference's ``fit`` saves the llama smoke LM after 5 steps;
    its ``step_5.npz`` is carried into the port (``np.load`` ->
    ``tree_from_checkpoint`` -> ``lm_params_from_jax`` /
    ``opt_state_from_jax``), and both resume for 3 more steps on the same
    batches: losses within 1e-5."""
    jcfg, jparams, cfg, _, _ = _builds("llama3-8b")
    jstep = jloop.make_train_step(
        lambda p, tokens, labels: jtf.lm_loss(p, jcfg, tokens, labels,
                                              dtype=jnp.float32),
        _opt(jopt), donate=False)
    jck = jckpt.CheckpointManager(str(tmp_path), keep=1)

    def data():
        return synthetic.lm_batches(cfg.vocab, 4, 17, seed=2)

    jloop.fit(jparams, jstep, data(), steps=5, ckpt=jck, ckpt_every=5,
              log_every=0)
    assert jck.all_steps() == [5]
    template = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstate, _ = jck.restore(template)
    jstate = jax.tree.map(jnp.asarray, jstate)
    _, _, jh = jloop.fit(jstate["params"], jstep, data(), steps=8,
                         opt_state=jstate["opt"], start_step=5, log_every=0)

    with np.load(jck._path(5)) as z:
        tree = tree_from_checkpoint(z)
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(tree["params"]))
    opt = tree["opt"]
    state = opt_state_from_jax((opt["m"], opt["v"], opt["step"]), model)
    tstep = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels), _opt(topt))
    _, ts, th = tloop.fit(model.requires_grad_(False), tstep, data(),
                          steps=8, opt_state=state, start_step=5,
                          log_every=0)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [5, 6, 7]
    for got, want in zip(th, jh):
        assert _rel(got["loss"], want["loss"]) <= 1e-5
    assert int(ts.step) == 8
