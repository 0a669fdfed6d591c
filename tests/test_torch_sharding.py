"""Port parity for the sharding rule table and the state specs
(``repro_torch.parallel.sharding``, ``repro_torch.parallel.state_sharding``,
``repro_torch.models.param_axes``, ``repro_torch.launch.mesh.make_production_mesh``).

- ``param_axes`` equals the reference's ``tree_axes(model_spec(cfg))`` on
  every registered arch, ``_smoke`` and full (pure Python, no devices);
- ``spec_for`` on a (data=2, model=4) and a (pod=2, data=2, model=2) mesh,
  with and without rule overrides, on a set of logical axes and shapes;
- the train-state specs (f32 moments; int8 moments with ``int8_ef``), the
  dense and paged cache specs, the batch specs and the prequant specs, leaf
  for leaf, on the reference ``test_sharding.py``'s three archs;
- ``replicated_dims``, the divisibility drops, the warn-once sites and
  ``dropped_rules``;
- the production meshes' shapes, and no rule naming an axis they lack;
- ``shard_tree`` / ``gather_tree`` round trip.

The reference's ``use_mesh`` enters ``with mesh:``, which wants a mesh of
devices, so its side runs once for the module in a subprocess on 8 host
devices (``--xla_force_host_platform_device_count=8``) and prints JSON.
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import model_spec
from repro.parallel.sharding import tree_axes
from repro_torch.configs.base import RunConfig, get_config, list_configs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import abstract_params, init, init_caches, param_axes
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    MeshShape,
    ReplicatedDimWarning,
    spec_for,
    use_mesh,
)
from repro_torch.parallel.state_sharding import (
    abstract_train_state,
    batch_specs,
    cache_specs,
    gather_tree,
    prequant_param_specs,
    shard_tree,
    train_state_specs,
)
from repro_torch.quant.surgery import apply_surgery
from repro_torch.tree import leaves_with_paths

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ["qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke", "falcon-mamba-7b_smoke"]
MESHES = {"dp_tp": [[2, 4], ["data", "model"]], "pod": [[2, 2, 2], ["pod", "data", "model"]]}
OVERRIDES = {"none": None, "sp": {"seq": "model", "heads": None, "experts": ["data", "model"]}}
RCS = {"f32": {}, "int8": {"moments_dtype": "int8", "grad_compression": "int8_ef"}}
PREQUANT = {"qwen3-0.6b_smoke": "attn.*=int8:prequant,mlp.*=int2:prequant,*=bf16",
            "deepseek-v2-lite-16b_smoke":
                "mla.*=int8:prequant,moe.*=int2:prequant,mlp.*=int2:prequant,*=bf16",
            "falcon-mamba-7b_smoke": "ssm.*=int8:prequant,*=bf16"}
PROBES = [[["batch", "seq"], [8, 32]], [["embed", "heads"], [64, 128]],
          [["heads", "embed"], [40, 64]], [["experts", "embed", "mlp"], [8, 64, 96]],
          [["layers", "embed", "kv_heads"], [2, 6, 16]], [["vocab", "embed"], [100, 64]],
          [["group", "seq", None], [16, 8, 4]], [["batch", "kv_seq", "cache_heads"], [4, 8, 2]],
          [[None, "batch", "seq"], [3, 8, 32]], [["seq", "act_heads"], [32, 16]]]
BATCH_SHAPES = {"tokens": [8, 32], "labels": [8, 32], "loss_mask": [8, 32],
                "positions": [3, 8, 32], "embeds": [8, 32, 512]}
CACHE = dict(batch=4, capacity=32, num_pages=12)

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys, warnings
    import jax, jax.numpy as jnp
    from repro.configs.base import RunConfig, get_config
    from repro.parallel import sharding as sh
    from repro.parallel import state_sharding as ss

    args = json.loads(sys.argv[1])

    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]

    def flat(tree):
        out = {}
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[name] = spec(s.spec)
        return out

    def ctx_record(ctx, warned):
        return {"replicated_dims": ctx.replicated_dims,
                "dropped": [[a, int(d), list(m) if isinstance(m, tuple) else m]
                            for a, d, m in ctx.dropped],
                "warned": warned,
                "dropped_rules": {str(k): list(v) if isinstance(v, tuple) else v
                                  for k, v in ctx.dropped_rules.items()}}

    def ovr(o):
        return None if o is None else {k: tuple(v) if isinstance(v, list) else v
                                       for k, v in o.items()}

    res = {"devices": len(jax.devices()), "probes": {}, "train": {}, "cache": {},
           "batch": {}, "prequant": {}}
    for mname, (shape, axes) in args["meshes"].items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes))
        for oname, o in args["overrides"].items():
            with warnings.catch_warnings(record=True) as w, \\
                    sh.use_mesh(mesh, overrides=ovr(o)) as ctx:
                warnings.simplefilter("always")
                got = [spec(sh.spec_for(tuple(a), tuple(s))) for a, s in args["probes"]]
                res["probes"][f"{mname}/{oname}"] = {"specs": got, **ctx_record(
                    ctx, sum(issubclass(x.category, sh.ReplicatedDimWarning) for x in w))}
        for arch in args["archs"]:
            cfg = get_config(arch)
            for rname, kw in args["rcs"].items():
                rc = RunConfig(dtype="float32", param_dtype="float32", **kw)
                with warnings.catch_warnings(record=True) as w, sh.use_mesh(mesh) as ctx:
                    warnings.simplefilter("always")
                    st = ss.abstract_train_state(cfg, rc)
                    res["train"][f"{mname}/{arch}/{rname}"] = {
                        "specs": flat(ss.train_state_sharding(cfg, rc, st)), **ctx_record(
                            ctx, sum(issubclass(x.category, sh.ReplicatedDimWarning)
                                     for x in w))}
            for layout in ("dense", "paged"):
                rc = RunConfig(dtype="float32", param_dtype="float32", kv_layout=layout,
                               kv_cache_dtype="int8")
                with sh.use_mesh(mesh):
                    c = ss.abstract_caches(cfg, rc, args["cache"]["batch"],
                                           args["cache"]["capacity"],
                                           num_pages=args["cache"]["num_pages"])
                    res["cache"][f"{mname}/{arch}/{layout}"] = flat(ss.cache_sharding(cfg, rc, c))
            rc = RunConfig(dtype="float32", param_dtype="float32",
                           quant_policy=args["prequant"][arch])
            with sh.use_mesh(mesh):
                q = ss.abstract_prequant_params(cfg, rc)
                res["prequant"][f"{mname}/{arch}"] = flat(ss.prequant_param_sharding(cfg, rc, q))
        with sh.use_mesh(mesh):
            b = {k: jax.ShapeDtypeStruct(tuple(v), jnp.int32)
                 for k, v in args["batch"].items()}
            res["batch"][mname] = flat(ss.batch_sharding(b))
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    arg = json.dumps({"meshes": MESHES, "overrides": OVERRIDES, "probes": PROBES,
                      "archs": ARCHS, "rcs": RCS, "cache": CACHE, "batch": BATCH_SHAPES,
                      "prequant": PREQUANT})
    out = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["devices"] == 8
    return res


def _mesh(name) -> MeshShape:
    shape, axes = MESHES[name]
    return MeshShape(tuple(axes), tuple(shape))


def _ovr(o):
    return None if o is None else {k: tuple(v) if isinstance(v, list) else v
                                   for k, v in o.items()}


def _json_spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _json_specs(specs: dict) -> dict:
    return {n: _json_spec(s) for n, s in specs.items()}


def _ctx_record(ctx, warned) -> dict:
    return {"replicated_dims": ctx.replicated_dims,
            "dropped": [[a, int(d), list(m) if isinstance(m, tuple) else m]
                        for a, d, m in ctx.dropped],
            "warned": warned,
            "dropped_rules": {str(k): list(v) if isinstance(v, tuple) else v
                              for k, v in ctx.dropped_rules.items()}}


def _axes_flat(tree, prefix="") -> dict:
    """{path: axes} of an axes tree (a leaf: a tuple of names / None)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_axes_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        out = {}
        for i, v in enumerate(tree):
            out.update(_axes_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", list_configs())
def test_param_axes_match_reference(arch):
    """Every parameter leaf's logical axes, and its shape, on every arch."""
    want = _axes_flat(tree_axes(model_spec(j_get_config(arch))))
    assert _axes_flat(param_axes(get_config(arch))) == want
    shapes = {n: tuple(t.shape) for n, t in leaves_with_paths(
        abstract_params(get_config(arch), RunConfig()))}
    ref_shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): tuple(s.shape)
                  for p, s in jax.tree_util.tree_flatten_with_path(
                      model_spec(j_get_config(arch)),
                      is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert shapes == ref_shapes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("override", list(OVERRIDES))
def test_spec_for_matches_reference(ref, mesh, override):
    with warnings.catch_warnings(record=True) as w, \
            use_mesh(_mesh(mesh), overrides=_ovr(OVERRIDES[override])) as ctx:
        warnings.simplefilter("always")
        got = [_json_spec(spec_for(tuple(a), tuple(s))) for a, s in PROBES]
        rec = _ctx_record(ctx, sum(issubclass(x.category, ReplicatedDimWarning) for x in w))
    assert {"specs": got, **rec} == ref["probes"][f"{mesh}/{override}"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rcname", list(RCS))
def test_train_state_specs_match_reference(ref, mesh, arch, rcname):
    """Leaf for leaf, with the context's drop and warning accounting."""
    cfg, rc = get_config(arch), RunConfig(dtype="float32", param_dtype="float32", **RCS[rcname])
    with warnings.catch_warnings(record=True) as w, use_mesh(_mesh(mesh)) as ctx:
        warnings.simplefilter("always")
        specs = train_state_specs(cfg, rc, abstract_train_state(cfg, rc))
        rec = _ctx_record(ctx, sum(issubclass(x.category, ReplicatedDimWarning) for x in w))
    assert {"specs": _json_specs(specs), **rec} == ref["train"][f"{mesh}/{arch}/{rcname}"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_prequant_specs_match_reference(ref, mesh, arch):
    cfg = get_config(arch)
    with use_mesh(_mesh(mesh)):
        for layout in ("dense", "paged"):
            rc = RunConfig(dtype="float32", param_dtype="float32", kv_layout=layout,
                           kv_cache_dtype="int8")
            caches = init_caches(cfg, rc, CACHE["batch"], CACHE["capacity"],
                                 num_pages=CACHE["num_pages"], device="cpu")
            assert _json_specs(cache_specs(cfg, rc, caches)) == \
                ref["cache"][f"{mesh}/{arch}/{layout}"]
        rc = RunConfig(dtype="float32", param_dtype="float32", quant_policy=PREQUANT[arch])
        params_q = apply_surgery(cfg, rc, init(cfg, rc, device="cpu"))
        assert _json_specs(prequant_param_specs(cfg, rc, params_q)) == \
            ref["prequant"][f"{mesh}/{arch}"]
        batch = {k: torch.empty(v, dtype=torch.int32, device="meta")
                 for k, v in BATCH_SHAPES.items()}
        assert _json_specs(batch_specs(batch)) == ref["batch"][mesh]


def test_warns_once_per_site():
    """One warning per distinct (axis, dim, mesh axis) under a context,
    every drop counted; a new context warns again."""
    mesh = make_local_mesh(2, 4)
    for _ in range(2):
        with warnings.catch_warnings(record=True) as w, use_mesh(mesh) as ctx:
            warnings.simplefilter("always")
            for _ in range(3):
                assert spec_for(("heads", "embed"), (6, 64)) == (None, "data")
            assert spec_for(("vocab",), (10,)) == (None,)
        assert ctx.replicated_dims == 4
        assert sum(issubclass(x.category, ReplicatedDimWarning) for x in w) == 2


def test_production_meshes():
    """The reference's shapes; every rule names an axis of the multi-pod
    mesh (or none), and the one-pod mesh drops exactly the ``pod`` axis."""
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    named = {a for v in DEFAULT_RULES.values() if v is not None
             for a in (v if isinstance(v, tuple) else (v,))}
    assert named <= set(two.axes)
    with use_mesh(one) as ctx:
        assert ctx.dropped_rules == {"batch": ("pod", "data"), "group": ("pod", "data", "model"),
                                     "group_data": ("pod", "data")}
        assert ctx.rules["batch"] == ("data",)
    with use_mesh(two) as ctx:
        assert ctx.dropped_rules == {}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_and_gather_round_trip(mesh):
    """Every rank's part of a train state, put back together, is the
    state bit for bit; each part has its spec's shape."""
    cfg = get_config("deepseek-v2-lite-16b_smoke")
    rc = RunConfig(dtype="float32", param_dtype="float32", moments_dtype="int8")
    from repro_torch.train import init_train_state

    state = init_train_state(cfg, rc, init(cfg, rc, device="cpu"))
    m = _mesh(mesh)
    with use_mesh(m):
        specs = train_state_specs(cfg, rc, state)
    parts = [shard_tree(specs, state, m.coords(r), m) for r in range(m.size)]
    back = dict(leaves_with_paths(gather_tree(specs, parts, m)))
    for n, t in leaves_with_paths(state):
        assert torch.equal(back[n], t.detach()), n
