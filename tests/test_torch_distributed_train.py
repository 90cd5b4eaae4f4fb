"""Port parity for the distributed training layer (CPU):
``distributed/sharding.py`` (``spec_for``, ``bytes_per_device``, the
placement and ``CheckpointManager.restore_sharded``),
``distributed/pipeline.py`` and ``collectives.compressed_psum``, each
against ``repro`` on the same numpy-seeded inputs, and every family's
``*_param_axes`` against its ``named_tensors``.

The reference side runs once, in one subprocess with 8 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it): every spec, the pipeline's output
and gradients, ``compressed_psum`` at 8 shards and the elastic
reshard's addressable shards. The port's mesh holds 8 coordinates on
the CPU.

Tolerances: specs, bytes, block indices and contents equal; the pipeline
within 1e-5 of the reference (values and gradients) and bit for bit with
the port's own sequential oracle; ``compressed_psum`` within 1e-6 x
max|sum| of the reference's, within its 3 % accuracy bound of the exact
sum, every replica equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import compressed_psum
from repro_torch.distributed.pipeline import (
    pipeline_apply,
    pipeline_bubble_fraction,
    pipeline_schedule,
)
from repro_torch.models import encoder as tenc
from repro_torch.models import gnn as tgnn
from repro_torch.models import recsys as trs
from repro_torch.models import transformer as ttf
from repro_torch.models.common import named_tensors
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import OptState, adamw_init, opt_state_axes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [((8,), ("model",)), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((1,), ("model",))]
RULES = [None, {"embed": "model"},
         {"vocab": ["data", "model"], "mlp": ["pod", "model"]},
         {"a": "model", "b": "model"}]
CASES = [((8, 16), ("vocab", "embed")), ((7, 3), ("vocab", None)),
         ((4, 4), ("a", "b")), ((64, 48), ("batch", "mlp")),
         ((6, 10, 12), ("layers", "embed", "heads")), ((16,), ("db_rows",)),
         ((), ()), ((12, 8), ("tokens", "expert")), ((9, 8), ("a", "mlp"))]
FAMILIES = {"fm": "fm", "wide-deep": "wide_deep", "bert4rec": "bert4rec",
            "mind": "mind"}
PIPE = dict(S=4, M=6, mb=8, d=16)
PSUM_N = (1000, 1003)

REFERENCE = r"""
import json, sys, tempfile
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_smoke_config
from repro.distributed.collectives import compressed_psum
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import (axis_rules, bytes_per_device,
                                        named_sharding, spec_for)
from repro.models import gnn, recsys, transformer as tf
from repro.train.checkpoint import CheckpointManager

spec_in, npz_in, out_dir = sys.argv[1:4]
cfg = json.load(open(spec_in))
inp = dict(np.load(npz_in))
out, arrays = {}, {}

def is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)

def named(axes, shapes, prefix=""):
    if is_axes(axes):
        return {prefix[:-1]: (axes, tuple(shapes.shape))}
    items = axes.items() if isinstance(axes, dict) else enumerate(axes)
    return {n: v for k, a in items
            for n, v in named(a, shapes[k], f"{prefix}{k}.").items()}

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

key = jax.random.PRNGKey(0)
trees = {}
for arch, kind in cfg["families"].items():
    c = get_smoke_config(arch)
    trees[arch] = named(recsys.AXES[kind](c), jax.eval_shape(
        lambda: recsys.INIT[kind](key, c)))
g = get_smoke_config("graphsage-reddit")
trees["graphsage-reddit"] = named(gnn.sage_param_axes(g), jax.eval_shape(
    lambda: gnn.init_sage(key, g, 8, 3)))
for arch in ("llama3-8b", "olmoe-1b-7b"):
    c = get_smoke_config(arch)
    trees[arch] = named(tf.lm_param_axes(c), jax.eval_shape(
        lambda: tf.init_lm(key, c)))
out["axes"] = {a: {n: list(v[0]) for n, v in t.items()}
               for a, t in trees.items()}

specs = []
for shape, names in cfg["meshes"]:
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    for rules in cfg["rules"]:
        r = None if rules is None else {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in rules.items()}
        with axis_rules(mesh, r):
            rows = [(shp, ax) for shp, ax in cfg["cases"]]
            for arch, t in trees.items():
                if arch in ("llama3-8b", "olmoe-1b-7b") and r is not None:
                    continue
                rows += [(list(s), list(a)) for a, s in t.values()]
            for shp, ax in rows:
                spec = spec_for(tuple(shp), tuple(ax))
                specs.append({"mesh": [shape, names], "rules": rules,
                              "shape": shp, "axes": ax, "spec": norm(spec),
                              "bytes": bytes_per_device(tuple(shp), spec,
                                                        mesh, 4)})
out["specs"] = specs

# the pipeline (tests/test_pipeline.py's setup) and its gradients
mesh = jax.make_mesh((4,), ("pp",))
params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
stage = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
f = lambda p: pipeline_apply(mesh, "pp", stage, p, jnp.asarray(inp["x"]))
arrays["pipe_out"] = np.asarray(f(params))
with jax.set_mesh(mesh):         # its transpose needs the mesh context
    grads = jax.grad(lambda p: jnp.sum(f(p)))(params)
arrays["pipe_gw"], arrays["pipe_gb"] = np.asarray(grads["w"]), \
    np.asarray(grads["b"])

mesh = jax.make_mesh((8,), ("x",))
for n in cfg["psum_n"]:
    fn = shard_map(lambda s: compressed_psum(s[0], "x"), mesh=mesh,
                   in_specs=P("x"), out_specs=P(None), check_rep=False)
    arrays[f"psum_{n}"] = np.asarray(fn(jnp.asarray(inp[f"psum_{n}"])))

# elastic: placed on a (4, 2) mesh, saved, restored onto (2, 4)
mesh_a = jax.make_mesh((4, 2), ("data", "model"))
mesh_b = jax.make_mesh((2, 4), ("data", "model"))
state = {"w": jnp.asarray(inp["el_w"]),
         "fm": {k[3:]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith("fm_")}}
axes = {"w": ("batch", "mlp"),
        "fm": recsys.fm_param_axes(get_smoke_config("fm"))}
with axis_rules(mesh_a):
    placed = jax.tree.map(lambda a, ax: jax.device_put(
        a, named_sharding(a.shape, *ax)), state, axes,
        is_leaf=lambda x: is_axes(x) or hasattr(x, "shape"))
ck = CheckpointManager(out_dir + "/ref_ckpt")
ck.save(1, placed)
got, _ = ck.restore_sharded(state, axes, mesh_b)
blocks = {}
coord = {d: [int(c) for c in np.argwhere(mesh_b.devices == d)[0]]
         for d in mesh_b.devices.flat}
for name, arr in (("w", got["w"]),
                  *((f"fm.{k}", v) for k, v in got["fm"].items())):
    rows = []
    for i, s in enumerate(arr.addressable_shards):
        idx = [[sl.start or 0, dim if sl.stop is None else sl.stop]
               for sl, dim in zip(s.index, arr.shape)]
        rows.append({"coord": coord[s.device], "index": idx})
        arrays[f"el_{name}_{len(rows) - 1}"] = np.asarray(s.data)
    blocks[name] = rows
out["elastic"] = blocks
json.dump(out, open(out_dir + "/ref.json", "w"))
np.savez(out_dir + "/ref.npz", **arrays)
print("OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    S, M, mb, d = (PIPE[k] for k in ("S", "M", "mb", "d"))
    inp = {"w": (rng.normal(size=(S, d, d)) * 0.3).astype(np.float32),
           "b": (rng.normal(size=(S, d)) * 0.1).astype(np.float32),
           "x": rng.normal(size=(M, mb, d)).astype(np.float32),
           "el_w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    for n in PSUM_N:
        inp[f"psum_{n}"] = rng.normal(size=(8, n)).astype(np.float32)
    for name, t in trec_fm().items():
        inp[f"fm_{name}"] = rng.normal(size=tuple(t.shape)).astype(
            np.float32)
    return inp


def trec_fm() -> dict:
    return trs.init_fm(get_smoke_config("fm"), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    (d / "cfg.json").write_text(json.dumps({
        "meshes": MESHES, "rules": RULES, "cases": CASES,
        "families": FAMILIES, "psum_n": PSUM_N}))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(d / "cfg.json"), str(d / "in.npz"), str(d)],
        capture_output=True, text=True, env=env, timeout=480)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads((d / "ref.json").read_text())
    with np.load(d / "ref.npz") as z:
        out["arrays"] = {k: z[k] for k in z.files}
    out["inputs"], out["dir"] = inp, d
    return out


def _spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _rules(rules):
    return None if rules is None else {
        k: tuple(v) if isinstance(v, list) else v for k, v in rules.items()}


def _cpu_mesh(shape, names):
    return tsh.Mesh(shape, names, device="cpu")


def test_spec_for_and_bytes_match_reference(ref):
    """Every (mesh, rules, shape, axes) of the table, the non-LM families'
    leaves under every rules and the LMs' stacked leaves under the
    default ones: the same spec and bytes per device."""
    n = 0
    for row in ref["specs"]:
        mesh = _cpu_mesh(*row["mesh"])
        with tsh.axis_rules(mesh, _rules(row["rules"])):
            spec = tsh.spec_for(tuple(row["shape"]), tuple(row["axes"]))
            assert tsh.current_mesh() is mesh
        assert _spec(spec) == row["spec"], row
        assert tsh.bytes_per_device(row["shape"], spec, mesh, 4) == \
            row["bytes"], row
        n += 1
    assert n > 500 and tsh.current_mesh() is None
    with tsh.axis_rules(None):
        assert tsh.spec_for((4, 4), ("vocab", "embed")) == ()
        assert tsh.named_sharding((4, 4), "vocab", "embed") is None


def _port_trees():
    out = {}
    for arch, kind in FAMILIES.items():
        c = get_smoke_config(arch)
        out[arch] = (trs.AXES[kind](c), trs.INIT[kind](c, device="cpu"))
    g = get_smoke_config("graphsage-reddit")
    out["graphsage-reddit"] = (tgnn.sage_param_axes(g),
                               tgnn.init_sage(g, 8, 3, device="cpu"))
    for arch in ("llama3-8b", "olmoe-1b-7b"):
        c = get_smoke_config(arch)
        out[arch] = (ttf.lm_param_axes(c), ttf.init_lm(c, device="cpu"))
    return out


def _lm_ref_name(name: str) -> tuple[str, bool]:
    """A port LM leaf -> (the reference's leaf, transposed?)."""
    parts = name.split(".")
    if parts[0] == "layers":
        leaf = parts[-1] if parts[-1] != "weight" else parts[-2]
        return f"layers.{leaf}", parts[-1] == "weight"
    if name == "out_head.weight":
        return "out_head", True
    return {"embed.weight": "embed"}.get(name, name), False


def test_param_axes_cover_named_tensors_and_match_reference(ref):
    """Each family's ``*_param_axes`` covers exactly its ``named_tensors``
    with one axis a dim, and equals the reference's outside the LM; an
    LM leaf takes the reference's axes without ``layers``, transposed
    where ``nn.Linear`` holds [out, in]."""
    for arch, (axes, params) in _port_trees().items():
        named = dict(named_tensors(params))
        assert sorted(axes) == sorted(named), arch
        for n, t in named.items():
            assert len(axes[n]) == t.dim(), (arch, n)
        want = ref["axes"][arch]
        if arch not in ("llama3-8b", "olmoe-1b-7b"):
            assert {n: list(a) for n, a in axes.items()} == want, arch
            continue
        for n, a in axes.items():
            rname, transposed = _lm_ref_name(n)
            r = want[rname]
            r = r[1:] if rname.startswith("layers.") else r
            assert list(a) == (r[::-1] if transposed else r), (arch, n)
    enc = tenc.encoder_param_axes(trs._bert4rec_enc_cfg(
        get_smoke_config("bert4rec")))
    assert {f"encoder.{n}": list(a) for n, a in enc.items()} == \
        ref["axes"]["bert4rec"]


def test_lm_specs_are_the_references_without_layers(ref):
    """Under the default rules an LM leaf's spec is the reference's
    stacked leaf's, less its ``layers`` entry and transposed as the
    leaf (``embed`` maps to no mesh axis, so no dim competes)."""
    stacked = {}
    for row in ref["specs"]:
        if row["rules"] is None:
            stacked[(tuple(row["mesh"][0]), tuple(row["shape"]),
                     tuple(row["axes"]))] = row["spec"]
    for shape, names in MESHES:
        mesh = _cpu_mesh(shape, names)
        for arch in ("llama3-8b", "olmoe-1b-7b"):
            axes, model = _port_trees()[arch]
            for n, t in named_tensors(model):
                with tsh.axis_rules(mesh):
                    spec = _spec(tsh.spec_for(t.shape, axes[n]))
                rname, transposed = _lm_ref_name(n)
                rshape = list(t.shape)[::-1] if transposed else list(t.shape)
                rax = ref["axes"][arch][rname]
                if rname.startswith("layers."):
                    rshape = [get_smoke_config(arch).n_layers] + rshape
                want = stacked[(tuple(shape), tuple(rshape), tuple(rax))]
                want = want[1:] if rname.startswith("layers.") else want
                assert spec == (want[::-1] if transposed else want), (n, mesh)


def test_opt_state_axes_remap_layers_to_zero():
    cfg = tenc.EncoderConfig(vocab=32, d_model=8, n_blocks=2, n_heads=2,
                             d_ff=16, max_len=8)
    axes = opt_state_axes(tenc.encoder_param_axes(cfg))
    assert isinstance(axes, OptState) and axes.step == ()
    assert axes.m["layers.wqkv"] == ("zero", "embed", "heads")
    assert axes.v["embed"] == ("vocab", "embed")
    lm = opt_state_axes(ttf.lm_param_axes(get_smoke_config("llama3-8b")))
    assert all("zero" not in a for a in lm.m.values())


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(params, x):
    out = []
    p = [{k: v[s] for k, v in params.items()} for s in range(PIPE["S"])]
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(PIPE["S"]):
            h = _stage(p[s], h)
        out.append(h)
    return torch.stack(out)


def _grads(fn, params, x):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = fn(leaves, x)
    gw, gb = torch.autograd.grad(out.sum(), [leaves["w"], leaves["b"]])
    return out.detach(), gw, gb


def test_pipeline_matches_reference_and_sequential_oracle(ref):
    """``tests/test_pipeline.py``'s setup (4 stages, 6 microbatches of 8 x
    16, tanh(h @ w + b)) on a 4-stage CPU mesh: the output and the
    gradients of its sum within 1e-5 of the reference's, and bit for bit
    with the port's sequential oracle."""
    inp = ref["inputs"]
    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    x = torch.from_numpy(inp["x"])
    mesh = _cpu_mesh((4,), ("pp",))
    got = _grads(lambda p, x: pipeline_apply(mesh, "pp", _stage, p, x),
                 params, x)
    want = _grads(_sequential, params, x)
    for g, w, r in zip(got, want, ("pipe_out", "pipe_gw", "pipe_gb")):
        assert torch.equal(g, w), r
        np.testing.assert_allclose(g.numpy(), ref["arrays"][r], rtol=1e-5,
                                   atol=1e-5)
    assert len(pipeline_schedule(4, 6)) == 9
    assert sorted(sm for t in pipeline_schedule(4, 6) for sm in t) == \
        [(s, m) for s in range(4) for m in range(6)]


def test_pipeline_of_lm_layers_is_bit_for_bit(ref):
    """Four llama smoke layers as four stages (``_train_layer`` through
    ``transformer.layer_stage``), 4 microbatches of 2 x 16 tokens, on a
    4-stage mesh whose stages share the CPU: the output and the gradients
    of its sum bit for bit against the layers run one after another."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=4)
    model = ttf.init_lm(cfg, seed=3, device="cpu")
    stacked = ttf.stack_layers(model)
    stage = ttf.layer_stage(cfg)
    x = torch.randn(4, 2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    mesh = _cpu_mesh((2, 4), ("data", "pp"))

    def sequential(p, x):
        ps = [{k: v[s] for k, v in p.items()} for s in range(4)]
        out = []
        for m in range(x.shape[0]):
            h = x[m]
            for s in range(4):
                h = stage(ps[s], h)
            out.append(h)
        return torch.stack(out)

    def run(fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
        out = fn(leaves, x)
        return out.detach(), torch.autograd.grad(out.sum(),
                                                 list(leaves.values()))

    got = run(lambda p, x: pipeline_apply(mesh, "pp", stage, p, x))
    want = run(sequential)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert pipeline_bubble_fraction(4, 4) == 3 / 7
    with pytest.raises(ValueError, match="stage_params lead with 2"):
        pipeline_apply(_cpu_mesh((3,), ("pp",)), "pp", stage,
                       {k: v[:2] for k, v in stacked.items()}, x)


def test_bubble_fraction():
    assert pipeline_bubble_fraction(4, 12) == 3 / 15
    assert pipeline_bubble_fraction(1, 8) == 0.0


@pytest.mark.parametrize("n", PSUM_N)
def test_compressed_psum_matches_reference(ref, n):
    """8 shards, n divisible by 8 and not: every replica equal, each
    within 1e-6 x max|sum| of the reference's and within its 3 % bound of
    the exact sum."""
    x = ref["inputs"][f"psum_{n}"]
    got = compressed_psum([torch.from_numpy(r) for r in x])
    assert len(got) == 8 and all(torch.equal(g, got[0]) for g in got)
    want = ref["arrays"][f"psum_{n}"]
    exact = x.astype(np.float64).sum(0)
    g = got[0].numpy()
    assert g.shape == (n,) and g.dtype == np.float32
    assert np.abs(g - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(g - exact).max() / np.abs(exact).max() < 0.03


def test_elastic_reshard_matches_reference(ref, tmp_path):
    """The reference's ``test_elastic_checkpoint_reshard`` with an fm
    tree beside its [8, 8] leaf: placed on a (4, 2) mesh, saved (the
    reference's members), restored onto (2, 4): each coordinate's block
    index and contents equal the reference's, the blocks joined equal the
    saved leaves."""
    inp = ref["inputs"]
    state = {"w": torch.from_numpy(inp["el_w"]),
             "fm": {k[3:]: torch.from_numpy(v) for k, v in inp.items()
                    if k.startswith("fm_")}}
    axes = {"w": ("batch", "mlp"),
            "fm": trs.fm_param_axes(get_smoke_config("fm"))}
    mesh_a = _cpu_mesh((4, 2), ("data", "model"))
    mesh_b = _cpu_mesh((2, 4), ("data", "model"))
    with tsh.axis_rules(mesh_a):
        placed = {"w": tsh.device_put(state["w"], tsh.named_sharding(
            (8, 8), "batch", "mlp")),
            "fm": {k: tsh.device_put(v, tsh.named_sharding(
                v.shape, *axes["fm"][k])) for k, v in state["fm"].items()}}
    ck = tckpt.CheckpointManager(str(tmp_path))
    ck.save(1, placed)
    with np.load(ck._path(1)) as a, \
            np.load(os.path.join(ref["dir"], "ref_ckpt", "step_00000001.npz")
                    ) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    got, meta = ck.restore_sharded(state, axes, mesh_b)
    assert meta == {"step": 1}
    leaves = {"w": got["w"], **{f"fm.{k}": v for k, v in got["fm"].items()}}
    whole = {"w": state["w"],
             **{f"fm.{k}": v for k, v in state["fm"].items()}}
    assert {s.data.shape for s in got["w"].addressable_shards} == {(4, 2)}
    for name, arr in leaves.items():
        rows = ref["elastic"][name]
        by_coord = {tuple(r["coord"]): (i, r["index"])
                    for i, r in enumerate(rows)}
        assert len(arr.addressable_shards) == len(rows) == 8
        for coord, sh in zip(mesh_b.coords(), arr.addressable_shards):
            i, index = by_coord[coord]
            assert [[s.start, s.stop] for s in sh.index] == index, name
            assert np.array_equal(sh.data.numpy(),
                                  ref["arrays"][f"el_{name}_{i}"]), name
        assert torch.equal(arr.gather(), whole[name]), name


def test_mesh_defaults_and_devices():
    mesh = tsh.Mesh((2, 3), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.coords()[:2] == [(0, 0), (0, 1)]
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        tsh.Mesh((2,), ("a", "b"), device="cpu")
    x = torch.ones(3)
    assert tsh.shard(x, "batch") is x
    r = tsh.device_put(torch.arange(6.0).reshape(2, 3), tsh.replicated(mesh))
    assert all(torch.equal(s.data, r.gather()) for s in r.addressable_shards)
    with tsh.axis_rules(mesh):
        sh = tsh.param_sharding({"a": ("batch", None), "b": [("mlp",)]},
                                {"a": (4, 6), "b": [(9,)]})
    assert sh["a"].spec == ("data", None) and sh["b"][0].spec == ("model",)
    assert opt_state_axes({"w": ("layers", None)}).m == {"w": ("zero", None)}
    assert list(adamw_init({"w": torch.ones(2, 2)}).m) == \
        list(opt_state_axes({"w": ("layers", None)}).m)
