"""The port's sharding layer against `repro`'s, on the CPU:
`distributed/sharding` (rules, `pspec`, placements), `launch/mesh`,
`models/common.{param_pspecs,abstract_params}`,
`training/optimizer.{state_pspecs,abstract_state}` and reshard-on-restore.

- `repro`'s four `tests/test_sharding_and_hlo.py` rule cases, on the port.
- For each of the 11 archs of `ARCH_NAMES`, on abstract (1, 1), (16, 16) and (2, 16, 16)
  meshes under its family's rules: `param_pspecs` in the training and the
  serving layout, and `state_pspecs` for sgd, adamw and adam8bit, equal
  `repro`'s spec for spec (`repro` resolves on `jax.sharding.AbstractMesh`;
  JAX writes a one-name tuple entry as the bare name, and so does the
  comparison). `abstract_state` has `repro`'s shapes and dtypes.
- Each rank's block: one `repro` subprocess on 4 forced CPU devices gives
  `NamedSharding(mesh, spec).devices_indices_map(shape)` for specs that
  `param_pspecs` gives on (2, 2) and (1, 4); `distribute` on 4 gloo ranks
  gives each rank that block, and so does `checkpoint.restore` with
  `shardings` (as specs and as (mesh, placements)) after a save.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro.configs.base import ARCH_NAMES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.gnn import nequip as jnequip  # noqa: E402
from repro.models.recsys import api as jrec  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.gnn import nequip  # noqa: E402
from repro_torch.models.recsys import api as rec  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VIEWS = ("train", "serve", "sgd", "adamw", "adam8bit")
OPTIMIZERS = ("sgd", "adamw", "adam8bit")
D_FEAT = 1433  # nequip with node features (Cora's), beside its species table


# ---------------------------------------------------------------------------
# repro's rule cases (tests/test_sharding_and_hlo.py)
# ---------------------------------------------------------------------------


def test_pspec_dedup_axes():
    rules = {"batch": ("pod", "data"), "seq": "model", "kv": ("data", "model")}
    # duplicate mesh axes must appear at most once per spec
    s = sh.pspec(("batch", "kv"), rules)
    assert s == P(("pod", "data"), "model")
    s2 = sh.pspec(("seq", "kv"), rules)
    assert s2 == P("model", ("data",))


def test_pspec_trailing_none_trimmed():
    rules = {"batch": "data"}
    assert sh.pspec(("batch", None, None), rules) == P("data")


def test_adapt_rules_drops_missing_axes():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    adapted = sh.adapt_rules(sh.LM_RULES, mesh)
    assert adapted["batch"] == ("data",)  # 'pod' dropped
    assert adapted["fsdp"] == ("data", "model")
    assert adapted["__mesh__"] is mesh


def test_unknown_logical_axis_raises():
    with pytest.raises(KeyError):
        sh.pspec(("nope",), {"batch": "data"})


def test_rule_tables_are_repros():
    assert sh.FAMILY_RULES == jsh.FAMILY_RULES


# ---------------------------------------------------------------------------
# specs of every arch
# ---------------------------------------------------------------------------


def _defs(arch, get, transformer, recsys, gnn, **gnn_kw):
    cfg = get(arch)
    if cfg.family == "lm":
        return transformer.param_defs(cfg)
    if cfg.family == "recsys":
        return recsys.param_defs(cfg)
    return gnn.param_defs(cfg, **gnn_kw)


def _canon(tree):
    """A spec tree as plain tuples, a one-name tuple entry as the name."""
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    entries = tuple(tree)
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _jax_canon(tree):
    return jax.tree.map(lambda s: _canon(s), tree, is_leaf=lambda x: isinstance(x, JaxP))


CASES = [(arch, mesh, view, feat) for arch in ARCH_NAMES for mesh in MESHES for view in VIEWS
         for feat in ((None, D_FEAT) if arch == "nequip" else (None,))]


@pytest.mark.parametrize("arch,mesh,view,d_feat", CASES,
                         ids=[f"{a}-{m}-{v}" + (f"-feat{f}" if f else "")
                              for a, m, v, f in CASES])
def test_specs_match_repros(arch, mesh, view, d_feat):
    """`param_pspecs` (train, serve) or `state_pspecs` (sgd, adamw,
    adam8bit, over the training layout) equal `repro`'s."""
    shape, names = MESHES[mesh]
    family = get_config(arch).family
    jrules = jsh.adapt_rules(jsh.FAMILY_RULES[family], JaxAbstractMesh(shape, names))
    rules = sh.adapt_rules(sh.FAMILY_RULES[family], AbstractMesh(shape, names))
    jdefs = _defs(arch, jax_get_config, jtf, jrec, jnequip, d_feat=d_feat)
    defs = _defs(arch, get_config, tf, rec, nequip, d_feat=d_feat)
    serve = view == "serve"
    jspecs = jcommon.param_pspecs(jdefs, jrules, serve)
    specs = common.param_pspecs(defs, rules, serve)
    if view in OPTIMIZERS:
        jspecs = jopt.state_pspecs(view, jspecs, jcommon.abstract_params(jdefs))
        specs = opt.state_pspecs(view, specs, common.abstract_params(defs))
    assert _canon(specs) == _jax_canon(jspecs)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,optimizer", [(a, o) for a in ARCH_NAMES for o in OPTIMIZERS])
def test_abstract_params_and_state_match_repros(arch, optimizer):
    jdefs = _defs(arch, jax_get_config, jtf, jrec, jnequip)
    defs = _defs(arch, get_config, tf, rec, nequip)
    jparams, params = jcommon.abstract_params(jdefs), common.abstract_params(defs)
    jstate, state = jopt.abstract_state(optimizer, jparams), opt.abstract_state(optimizer, params)
    for jtree, tree in ((jparams, params), (jstate, state)):
        want = jax.tree.map(lambda a: (tuple(a.shape), _dtype_name(a.dtype)), jtree)
        got = common.tree_map(lambda t: (tuple(t.shape), _dtype_name(t.dtype)), tree)
        assert got == want
        assert all(t.device.type == "meta" for _, t in common.tree_leaves(tree))
    assert common.param_bytes(defs) == jcommon.param_bytes(jdefs)


def test_a_def_without_axes_is_refused():
    with pytest.raises(TypeError):
        common.ParamDef((4, 4))
    with pytest.raises(ValueError):
        common.ParamDef((4, 4), axes=(None,))
    with pytest.raises(ValueError):
        common.ParamDef((4, 4), axes=(None, None), serve_axes=("ff",))


# ---------------------------------------------------------------------------
# placements and blocks
# ---------------------------------------------------------------------------


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2), ("data", "model"))
    assert sh.placements(P(None, ("data", "model")), mesh) == [Shard(1), Shard(1)]
    assert sh.placements(P("model", "data"), mesh) == [Shard(1), Shard(0)]
    assert sh.placements(P(), mesh) == [Replicate(), Replicate()]
    for spec in (P("model", "data"), P(None, ("data", "model")), P(), P("data")):
        assert sh.spec_of(sh.placements(spec, mesh), mesh) == spec
    with pytest.raises(ValueError):  # a DTensor shards one dim over mesh dims in mesh order
        sh.placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError):
        sh.placements(P("pod"), mesh)


def test_block_slices_refuse_a_dim_the_mesh_does_not_divide():
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="not divisible"):
        sh.block_slices((6, 4), P(("data", "model")), mesh, (0, 0))
    assert sh.block_slices((8, 4), P(("data", "model")), mesh, (1, 0)) == \
        (slice(4, 6), slice(0, 4))


def _layout_cases():
    """(mesh shape, spec, small shape) for specs `param_pspecs` gives on
    (2, 2) and (1, 4): the LM's FSDP and TP layouts, the MoE's expert
    layouts, a recsys table's rows."""
    picks = [("olmoe_1b_7b", False, ("attn", "wq")), ("olmoe_1b_7b", False, ("moe", "w_gate")),
             ("olmoe_1b_7b", True, ("moe", "w_down")), ("yi_6b", True, ("attn", "wo")),
             ("yi_6b", True, ("ffn", "w_up")), ("yi_6b", True, ("embed",)),
             ("llama4_maverick_400b_a17b", False, ("moe", "shared_gate")),
             ("fm", False, ("table",))]
    out = []
    for mesh_shape in ((2, 2), (1, 4)):
        mesh = AbstractMesh(mesh_shape, ("data", "model"))
        for arch, serve, path in picks:
            family = get_config(arch).family
            specs = common.param_pspecs(_defs(arch, get_config, tf, rec, nequip),
                                        sh.adapt_rules(sh.FAMILY_RULES[family], mesh), serve)
            for k in path:
                specs = specs[k]
            rank = {"wq": 3, "w_gate": 4, "w_down": 4, "wo": 3, "w_up": 3, "embed": 2,
                    "shared_gate": 3, "table": 2}[path[-1]]
            out.append((mesh_shape, specs, (4, 8, 8, 4)[:rank]))
    assert any(len(s) > 1 and isinstance(s[-1], tuple) for _, s, _ in out)  # a tuple entry
    return out


_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

cases = json.loads(sys.argv[1])
devices = jax.devices()[:4]
out = []
for mesh_shape, spec, shape in cases:
    grid = np.array(devices).reshape(mesh_shape)
    mesh = Mesh(grid, ("data", "model"))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    index = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    blocks = {}
    for coord in np.ndindex(*mesh_shape):
        sl = index[grid[coord]]
        blocks[str(list(coord))] = [[s.start or 0, n if s.stop is None else s.stop]
                                    for s, n in zip(sl, shape)]
    out.append(blocks)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layouts")
    cases = _layout_cases()
    ref = torch_ranks.Reference(_REFERENCE, [json.dumps([[list(m), list(s), list(n)]
                                                         for m, s, n in cases])], 4)
    try:
        ranks = torch_ranks.run_ranks(torch_ranks.layout_rank, 4, tmp, cases,
                                      str(tmp / "ckpt"))
        one = torch_ranks.run_ranks(torch_ranks.mesh_rank, 1, tmp)[0]
        two = torch_ranks.run_ranks(torch_ranks.two_rank_layouts_rank, 2, tmp)
        out = ref.wait()
    finally:
        ref.kill()
    return cases, json.loads(out), ranks, one, two


@pytest.mark.parametrize("case", range(16))
def test_each_ranks_block_is_repros(case, layouts):
    cases, ref, ranks, _, _ = layouts
    assert len(cases) == 16
    mesh_shape, spec, shape = cases[case]
    whole = np.arange(float(np.prod(shape)), dtype=np.float32).reshape(shape)
    seen = set()
    for r in ranks:
        got = r[case]
        seen.add(got["coord"])
        block = tuple(slice(a, b) for a, b in ref[case][str(list(got["coord"]))])
        np.testing.assert_array_equal(got["local"], whole[block])
        for restored in got["restored"]:
            np.testing.assert_array_equal(restored, whole[block])
        assert got["whole"]
        assert len(set(map(tuple, got["placements"]))) == 1
    assert len(seen) == 4


def test_test_mesh_constrain_and_a_moe_transformer_through_the_mesh(layouts):
    one = layouts[3]
    assert one["shape"] == (1, 1) and one["names"] == ("data", "model")
    assert one["batch"] == ("data",) and one["fsdp"] == ("data", "model")
    assert one["mesh_threaded"]
    assert one["refused"] == ["need 256 ranks for mesh (16, 16); have 1",
                              "need 512 ranks for mesh (2, 16, 16); have 1"]
    assert one["constrained"] == ["S(0)", "S(0)"] and one["constrained_whole"]
    assert one["plain_untouched"]
    # the mesh reaches every MoE layer's dispatch: at one rank the same bits
    assert one["transformer_same_bits"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_a_moe_transformer_runs_tp_training_and_int8_prefill_on_two_ranks(shape, layouts):
    # the forward is split across ranks in the "fsdp" training layout, the
    # serving one, the Megatron one (train_layout="tp") and int8_serve's: on
    # a mesh of two ranks the loss, its gradients and the int8 prefill are
    # the one-rank call's blocks within 1e-5 of the largest |value|
    for r in layouts[4]:
        for name in ("loss", "prefill"):
            assert r[(shape, name)] <= 1e-5, (shape, name, r[(shape, name)])