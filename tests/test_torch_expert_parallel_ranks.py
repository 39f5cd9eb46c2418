"""`repro_torch.distributed.expert_parallel.moe_ffn_ep` across gloo ranks
against `repro`'s shard_map on the same mesh, on the CPU.

`repro` subprocesses on 4 forced CPU devices
(`--xla_force_host_platform_device_count=4`, which the pytest process never
sets), one a mesh, compute every case on meshes (data, model) = (1, 4), (2, 2) and
(2, 1): the output, aux and the gradients of Σ out·G + c·aux, G a fixed
cotangent. The port runs the same cases on 4, 4 and 2 gloo ranks, each
holding its blocks of the inputs (`ep_specs`), and backpropagates
Σ out_r·G_r + c·aux/n on each rank r (see `moe_ffn_ep`'s docstring).
Each mesh is held against `repro` on that mesh: `repro`'s aux is the mean
of the shards' own, so it and the gradients of x and the router depend on
the mesh.

Inputs are `test_torch_moe`'s `_setup` (x [2, 16, 32], f32); `_routing`
checks that no two router probabilities tie at the top-k boundary.
Tolerance: 1e-5 of the largest |value| of `repro`'s, as `test_torch_moe`
holds the one-group path; the drop counts of each rank, worked out here
from `repro`'s routing with a stable sort per bin, exactly.
"""
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.distributed.expert_parallel import _capacity, ep_specs  # noqa: E402
from repro_torch.distributed.sharding import LM_RULES, adapt_rules, block_slices  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from test_torch_moe import _routing, _setup  # noqa: E402

F32_TOL = 1e-5
COEF = 0.7  # the aux term's weight in the loss
MESHES = [(1, 4), (2, 2), (2, 1)]
# the reference's 24 jitted cases compile in ~22 s instead of ~31 (1e-5 holds)
CHEAP_XLA = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"
CASES = [(mesh, E, K, shared, cf) for mesh in MESHES for (E, K) in [(8, 2), (4, 4)]
         for shared in (0, 1) for cf in (8.0, 0.5)]

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import LMConfig
from repro.distributed.expert_parallel import moe_ffn_ep
from repro.distributed.sharding import LM_RULES, adapt_rules
from repro.launch.mesh import compat_make_mesh

inputs, out_path, coef = sys.argv[1], sys.argv[2], float(sys.argv[3])
data = np.load(inputs, allow_pickle=True)
cases = json.loads(str(data["cases"]))
results = {}
for i in map(int, sys.argv[4].split(",")):
    shape, kw = cases[i]
    n = shape[0] * shape[1]
    mesh = compat_make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n])
    rules = adapt_rules(LM_RULES, mesh)
    cfg = LMConfig(**kw)
    names = [k[len(f"{i}/p/"):] for k in data.files if k.startswith(f"{i}/p/")]
    lp = {k: jnp.asarray(data[f"{i}/p/{k}"]) for k in names}
    x, cot = jnp.asarray(data[f"{i}/x"]), jnp.asarray(data[f"{i}/cot"])

    def loss(x, lp):
        out, aux = moe_ffn_ep(x, lp, cfg, rules)
        return jnp.sum(out * cot) + coef * aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(x, lp)
    results[f"{i}/out"] = np.asarray(out)
    results[f"{i}/aux"] = np.asarray(aux)
    results[f"{i}/g/x"] = np.asarray(gx)
    for k, v in gp.items():
        results[f"{i}/g/{k}"] = np.asarray(v)
np.savez(out_path, **results)
"""


def _cfg_kwargs(E, K, cf, shared):
    return dict(name="m", family="lm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=64, n_experts=E, top_k=K, capacity_factor=cf,
                n_shared_experts=shared, dtype="float32")


def _inputs(E, K, shared, cf):
    _, _, lp, x = _setup(E=E, K=K, cf=cf, shared=shared)
    eidx = _routing(lp, x, K).reshape(x.shape[0], x.shape[1], K)
    params = {k: np.asarray(v) for k, v in lp.items()}
    cot = np.random.default_rng(E * 10 + K).standard_normal(x.shape).astype(np.float32)
    return params, np.asarray(x), cot, eidx


def _expected_drops(eidx, mesh_shape, E, K, cf):
    """Each mesh coordinate's [dropped_pair, dropped_expert]: stage 1 keeps
    the first C_pair of a rank's token-major entries per target group;
    stage 2 the first C_e per local expert of what a rank receives."""
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    x_spec, _ = ep_specs(adapt_rules(LM_RULES, mesh), False)
    n_groups = mesh_shape[1]
    E_loc = E // n_groups
    coords = list(itertools.product(*(range(n) for n in mesh_shape)))
    sent, drops = {}, {}  # sent: (coord, target group) -> local expert ids kept, in order
    for coord in coords:
        b, s, _ = block_slices(eidx.shape[:2] + (1,), x_spec, mesh, coord)
        flat = eidx[b, s].reshape(-1)
        c_pair = _capacity(flat.shape[0], n_groups, cf)
        dropped = 0
        for g in range(n_groups):
            mine = flat[flat // E_loc == g]
            dropped += max(0, len(mine) - c_pair)
            sent[coord, g] = mine[:c_pair] - g * E_loc
        drops[coord] = [dropped, 0]
    c_e = _capacity(n_groups * c_pair, E_loc, cf)
    for i, j in coords:
        got = np.concatenate([sent[(i, src), j] for src in range(n_groups)])
        drops[i, j][1] = int(sum(max(0, int(np.sum(got == e)) - c_e) for e in range(E_loc)))
    return drops


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through `repro` and the port (a subprocess and a spawn of
    gloo ranks per mesh), the two at once."""
    tmp = tmp_path_factory.mktemp("ep_ranks")
    arrays, meta, inputs = {}, [], {}
    for i, (mesh, E, K, shared, cf) in enumerate(CASES):
        params, x, cot, eidx = _inputs(E, K, shared, cf)
        inputs[i] = (params, x, cot, eidx)
        meta.append([list(mesh), _cfg_kwargs(E, K, cf, shared)])
        arrays.update({f"{i}/x": x, f"{i}/cot": cot})
        arrays.update({f"{i}/p/{k}": v for k, v in params.items()})
    np.savez(tmp / "inputs.npz", cases=np.array(json.dumps(meta)), **arrays)
    # the reference, a process per mesh, runs while the port's ranks do
    refs = [torch_ranks.Reference(
        _REFERENCE, [tmp / "inputs.npz", tmp / f"ref{m}.npz", COEF,
                     ",".join(str(i) for i, c in enumerate(CASES) if c[0] == mesh)],
        4, CHEAP_XLA) for m, mesh in enumerate(MESHES)]
    try:
        port = {}
        for mesh in MESHES:
            idx = [i for i, c in enumerate(CASES) if c[0] == mesh]
            cases = [(meta[i][1], inputs[i][0], inputs[i][1], inputs[i][2]) for i in idx]
            ranks = torch_ranks.run_ranks(torch_ranks.ep_rank, mesh[0] * mesh[1], tmp, mesh,
                                          cases, COEF)
            for n, i in enumerate(idx):
                port[i] = [rank[n] for rank in ranks]
        for ref in refs:
            ref.wait()
    finally:
        for ref in refs:
            ref.kill()
    ref = {k: v for m in range(len(MESHES)) for k, v in np.load(tmp / f"ref{m}.npz").items()}
    return ref, port, inputs


def _rel(ref, got, scale=None):
    """max |ref - got| over the largest |value| of the reference (`scale`,
    the whole tensor's, where `ref` is one rank's block of it)."""
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = np.max(np.abs(ref)) if scale is None else scale
    return float(np.max(np.abs(ref - got)) / max(scale, 1e-30))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"mesh{m[0]}x{m[1]}-E{E}K{K}-shared{s}-cf{cf}"
                              for m, E, K, s, cf in CASES])
def test_moe_ffn_ep_across_ranks_matches_repro_on_the_same_mesh(case, runs):
    ref, port, inputs = runs
    mesh_shape, E, K, shared, cf = CASES[case]
    params, x, _, eidx = inputs[case]
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    x_spec, specs = ep_specs(adapt_rules(LM_RULES, mesh), bool(shared))
    ranks = port[case]
    assert len({r["coord"] for r in ranks}) == len(ranks)

    out = np.full(x.shape, np.nan, np.float32)
    for r in ranks:
        out[block_slices(x.shape, x_spec, mesh, r["coord"])] = r["out"]
    errs = {"out": _rel(ref[f"{case}/out"], out)}
    errs["aux"] = max(_rel(ref[f"{case}/aux"].reshape(1), np.array([r["aux"]], np.float32))
                      for r in ranks)
    for name, full in [("x", x)] + sorted(params.items()):
        spec = x_spec if name == "x" else specs[name]
        g = ref[f"{case}/g/{name}"]
        errs[f"grad_{name}"] = max(
            _rel(g[block_slices(full.shape, spec, mesh, r["coord"])], r["grads"][name],
                 np.max(np.abs(g)))
            for r in ranks)
    print(json.dumps({"case": case, **errs}))
    assert max(errs.values()) <= F32_TOL, errs

    drops = _expected_drops(eidx, mesh_shape, E, K, cf)
    assert {r["coord"]: [r["dropped_pair"], r["dropped_expert"]] for r in ranks} == drops
    if cf < 1:
        assert sum(d for pair in drops.values() for d in pair) > 0
