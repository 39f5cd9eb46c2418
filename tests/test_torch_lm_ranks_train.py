"""The LM trunk's train cells across gloo ranks against `repro`'s jitted cell
functions on the same meshes, on the CPU.

`repro` subprocesses on 4 forced CPU devices
(`--xla_force_host_platform_device_count=4`, which the pytest process never
sets), one a mesh, jit each case with the shardings that
`repro.launch.cells._lm_cell` gives it under `LM_RULES`, on (data, model) =
(1, 4), (2, 2), (4, 1) and (pod, data, model) = (2, 1, 2): the loss with
every gradient leaf (the training layout: tokens split by batch over the
dp dims and by sequence over "model", the weights FSDP-split on their
"fsdp" dim), the train cell's AdamW step with `accum=1`, and with
`accum=2` (microbatches of the global batch) for the yi- and
olmoe-shaped archs. The port runs the same cases through
`launch/cells.build_cell` on the same meshes of 4 gloo ranks
(`torch_ranks.lm_rank`, one spawn for the four meshes), each rank on its
blocks of the same numpy inputs. (`test_torch_lm_ranks_serve` holds each
kind's cell on the (1, 1) mesh to the plain call, to the bit.)

The archs, reduced to 2 layers (llama4: one super-layer of a dense and a
routed layer) in f32 with D, d_ff and the vocabulary multiples of 512 (so
that "fsdp" lands on a dim: `_fsdp_axes`) and 4 heads of 32 (`_desc`):
yi_6b-shaped (GQA, 2 kv heads) and olmoe-shaped (4 experts top-2, every
layer routed, MHA) on all four meshes; chatglm3-shaped (QKV bias, RoPE on
half the head), command_r-shaped (the parallel block, layernorm, tied
tables) and llama4-shaped (interleave 2, a shared expert) on (2, 2). The
attention is the KV-chunked one (`q_chunk` 8 of a 16-token sequence, so
a rank's queries meet every chunk of the gathered keys).

Tolerances, of the largest |value| of each of `repro`'s output leaves:
the loss and metrics 1e-5; each gradient leaf, and the step's moments,
`GRAD_TOL` (measured below 4e-6: the ranks' and GSPMD's sums of the FSDP
gathers' reduce-scatters and of the loss take other orders). The step's updated parameters follow the port's AdamW
rule (`test_torch_optimizer`): every element within 2·lr, at most
`ADAM_FLIP_SHARE` of them further than `ADAM_ATOL`.
"""
import dataclasses
import json
import pickle
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import LMShape  # noqa: E402
from repro_torch.distributed.sharding import P, PartitionSpec, block_slices  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axis_names  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import init_params, to_numpy_tree  # noqa: E402
from test_torch_expert_parallel_ranks import CHEAP_XLA  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE  # noqa: E402

MESHES = [(1, 4), (2, 2), (4, 1), (2, 1, 2)]
ARCHS = {"yi": "yi_6b", "olmoe": "olmoe_1b_7b", "chatglm": "chatglm3_6b",
         "command_r": "command_r_35b", "llama4": "llama4_maverick_400b_a17b"}
ALL_MESHES = ("yi", "olmoe")  # the rest run on (2, 2)
TOL = 1e-5
GRAD_TOL = 1e-5
LR = 1e-4  # the cells' AdamW
# adam8bit's int8 codes: within one step of `repro`'s, at most this share
# of them off (the rule of its jitted update on shared gradients,
# `test_torch_optimizer`)
A8_CODE_SHARE = 1e-3
B, S = 8, 16  # train: 8 sequences of 16 tokens
LONG_WINDOW, LONG_GLOBAL = 256, 64  # the long-context cases' C2 pattern
# alone the references and the ranks take ~35 and ~25 s, together ~60;
# the cut leaves room for a loaded machine
DEADLINE_S = 240
SHAPES = {"grad": ("train_4k", LMShape("train_4k", S, B, "train")),
          "step": ("train_4k", LMShape("train_4k", S, B, "train"))}


def _desc(arch):
    """What both packages build an arch's reduced config from."""
    full = get_config(ARCHS[arch])
    over = {"n_layers": 2, "d_model": 512, "n_heads": 4, "head_dim": 32,
            "n_kv_heads": 4 if full.n_kv_heads == full.n_heads else 2, "d_ff": 512,
            "vocab_size": 512, "dtype": "float32", "q_chunk": 8}
    if full.n_experts:
        over.update(n_experts=4, top_k=min(full.top_k, 2))
    return {"arch": ARCHS[arch], "over": over}


def port_cfg(desc, **more):
    return dataclasses.replace(get_config(desc["arch"]), **{**desc["over"], **more})


def params_of(arch):
    """The whole numpy params of an arch (the port's `init_params`, seed by
    arch; the packages' defs are equal, `test_torch_sharding`)."""
    cfg = port_cfg(_desc(arch))
    gen = torch.Generator().manual_seed(list(ARCHS).index(arch))
    return to_numpy_tree(init_params(transformer.param_defs(cfg), gen, "cpu"))


def case_id(c):
    return f"{c[0]}-{c[1]}" + (f"-accum{c[2]}" if c[2] > 1 else "") + \
        "-" + "x".join(map(str, c[3]))


def train_inputs(i, arch, kind):
    """A train case's batch, one an arch (the reference computes a grad
    case and the step of its arch and mesh in one call); the params and a
    fresh AdamW state come from the arch."""
    rng = np.random.default_rng(200 + list(ARCHS).index(arch))
    vocab = _desc(arch)["over"]["vocab_size"]
    return ({k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")},)


REFERENCE = r"""
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.configs.shapes import LMShape
from repro.distributed.sharding import LM_RULES, adapt_rules, pspec
from repro.launch.cells import _int8_lm_defs, _lm_cell
from repro.launch.mesh import compat_make_mesh
from repro.models import transformer as tf
from repro.models.common import param_pspecs
from repro.training.optimizer import get_optimizer


def flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(f"{prefix}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for j, v in enumerate(tree):
            flat(f"{prefix}/{j}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def ns(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


with open(sys.argv[1], "rb") as f:
    cases, params = pickle.load(f)
shape = tuple(json.loads(sys.argv[3]))
names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
mesh = compat_make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
rules = adapt_rules(LM_RULES, mesh)
out = {}
for i, case in cases:
    cfg = dataclasses.replace(get_config(case["desc"]["arch"]),
                              **{**case["desc"]["over"], **case.get("more", {})})
    kind, opt = case["kind"], case.get("optimizer", "adamw")
    p = jax.tree.map(jnp.asarray, params[case.get("params", case["desc"]["arch"])])
    args = (p,) + jax.tree.map(jnp.asarray, case["args"])
    if kind in ("step", "train"):
        args = (p, get_optimizer(opt).init(p)) + args[1:]
    if kind == "long":
        lrules = {**rules, "batch": None}
        c_spec = pspec(tf.cache_axes(cfg, long_context=True), lrules)
        defs = tf.param_defs(cfg)
        p_specs = param_pspecs(_int8_lm_defs(defs) if cfg.int8_serve else defs, lrules,
                               serve=True)
        in_sh = ns(mesh, (p_specs, (c_spec, c_spec), P(), P()))
        out_sh = ns(mesh, (P(), (c_spec, c_spec)))
        fn = jax.jit(lambda p, c, t, q: tf.decode(p, c, t, q, cfg, lrules), in_shardings=in_sh,
                     out_shardings=out_sh)
    else:
        cell = _lm_cell(cfg, LMShape(**case["shape"]), mesh, rules, opt, accum=case["accum"])
        if kind == "train":  # an arch's gradients and steps on this mesh, one compile
            sh = cell.in_shardings
            trules = {**rules, "seq": None} if cfg.train_layout == "tp" else rules  # the cell's
            vg = jax.value_and_grad(lambda p, b: tf.loss(p, b, cfg, trules), has_aux=True)
            fns, outs = [], []
            for _, part, accum in case["parts"]:
                if part == "grad":
                    fns.append(lambda p, o, b: (lambda r: (r[0][0], r[1]))(vg(p, b)))
                    outs.append((NamedSharding(mesh, P()), sh[0]))
                else:
                    step = _lm_cell(cfg, LMShape(**case["shape"]), mesh, rules, opt,
                                    accum=accum)
                    fns.append(step.fn)
                    outs.append(step.out_shardings)
            res = jax.jit(lambda p, o, b: tuple(f(p, o, b) for f in fns), in_shardings=sh,
                          out_shardings=tuple(outs))(*args)
            for (j, _, _), r in zip(case["parts"], res):
                flat(str(j), r, out)
            continue
        fn = jax.jit(cell.fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)
    if kind in ("decode", "long"):
        logits, cache, tokens, pos = [], args[1], args[2], args[3]
        for t in range(tokens.shape[0]):
            lg, cache = fn(p, cache, tokens[t], pos + t)
            logits.append(lg)
        res = (jnp.stack(logits), cache)
    else:
        res = fn(*args)
    flat(str(i), res, out)
np.savez(sys.argv[2], **out)
"""


def flat(prefix, tree, out):
    if isinstance(tree, PartitionSpec):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            flat(f"{prefix}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for j, v in enumerate(tree):
            flat(f"{prefix}/{j}", v, out)
    else:
        out[prefix] = tree
    return out


def _port_case(i, case, inputs, shapes, variants=None):
    """Case i, (arch, kind, accum, mesh), for the port's ranks. A kind
    "v:k" is kind k of variant v: `variants[v]` = (config overrides, the
    step's optimizer)."""
    arch, kind, accum, mesh = case
    variant, kind = kind.split(":") if ":" in kind else ("", kind)
    over, optimizer = (variants or {}).get(variant, ({}, "adamw"))
    desc = _desc(arch)
    shape_name, shape = shapes[kind]
    more = dict(over)
    if kind == "long":
        more.update(attn_window=LONG_WINDOW, attn_n_global=LONG_GLOBAL, sparse_attention=True)
    cfg = port_cfg(desc, **more)
    return {"arch": desc["arch"], "shape_name": shape_name, "shape": shape, "cfg": cfg,
            "kind": "decode" if kind == "long" else kind, "ref_kind": kind, "accum": accum,
            "mesh": mesh, "args": inputs(i, arch, kind), "more": more, "optimizer": optimizer,
            "params": params_key(desc["arch"], cfg)}


def params_key(arch, cfg):
    """The key of a case's whole params: the arch's, or another tree where
    its config changes their shapes or kinds (another d_ff, int8)."""
    base = port_cfg(_desc(next(a for a, n in ARCHS.items() if n == arch)))
    key = arch + ("" if cfg.d_ff == base.d_ff else f":ff{cfg.d_ff}")
    return key + (":int8" if cfg.int8_serve else "")


def params_for(key):
    """The whole numpy params of `params_key`'s key: `params_of`'s, or,
    with another d_ff, those of that config (the same seed); with int8,
    `int8_params`' conversion of them."""
    arch, *rest = key.split(":")
    short = next(a for a, n in ARCHS.items() if n == arch)
    ff = next((int(r[2:]) for r in rest if r.startswith("ff")), None)
    if ff is None:
        params = params_of(short)
    else:
        cfg = port_cfg(_desc(short), d_ff=ff)
        gen = torch.Generator().manual_seed(list(ARCHS).index(short))
        params = to_numpy_tree(init_params(transformer.param_defs(cfg), gen, "cpu"))
    return int8_params(params, list(ARCHS).index(short)) if "int8" in rest else params


def int8_params(params, seed):
    """`repro`'s int8 serving tree (`transformer.int8_param_defs`) over
    whole numpy params: each converted weight's int8 codes and positive f32
    scales drawn from `seed` (per out channel of a matrix, scaled by
    1/√d_in; per row of a table), the other leaves as they are."""
    rng = np.random.default_rng(1000 + seed)

    def visit(name, v):
        if isinstance(v, dict):
            return {k: visit(k, x) for k, x in v.items()}
        if v.ndim < 2 or name.startswith(("attn_norm", "ffn_norm", "b")) or "norm" in name:
            return v
        q = rng.integers(-127, 128, v.shape).astype(np.int8)
        if name in ("embed", "lm_head"):
            s = rng.uniform(0.5, 1.5, v.shape[:1]) / 127
        else:
            s = rng.uniform(0.5, 1.5, v.shape[:-2] + v.shape[-1:]) / 127 / np.sqrt(v.shape[-2])
        return {"q": q, "s": s.astype(np.float32)}

    return {k: (v if k == "moe" else visit(k, v)) for k, v in params.items()}


def run_all(tmp, cases, inputs, shapes, one_rank=(), ref_size=6, variants=None):
    """Every case through `repro` (subprocesses of at most `ref_size` cases
    of one mesh) and the port (4 gloo ranks, all meshes in one spawn), the
    two at once; then the cases `one_rank` on one rank against the plain
    call. A case is (arch, kind, accum, mesh); `inputs(i, arch, kind)` its
    own whole args; `shapes` kind -> (shape name, LMShape); `variants` as
    `_port_case`'s. Returns (port cases, {mesh: reference arrays}, {mesh:
    per rank, its results}, the one-rank equalities)."""
    by_mesh = {m: [] for m in MESHES}
    port_cases = [_port_case(i, c, inputs, shapes, variants) for i, c in enumerate(cases)]
    one_cases = [_port_case(i, c, inputs, shapes, variants) for i, c in enumerate(one_rank)]
    params = {k: params_for(k) for k in sorted({c["params"] for c in port_cases + one_cases})}
    for i, ((arch, _, accum, mesh), pc) in enumerate(zip(cases, port_cases)):
        by_mesh[mesh].append((i, {"desc": _desc(arch), "more": pc["more"],
                                  "kind": pc["ref_kind"], "accum": accum, "args": pc["args"],
                                  "shape": dataclasses.asdict(pc["shape"]),
                                  "optimizer": pc["optimizer"], "params": pc["params"]}))
    for m, ref_cases in by_mesh.items():  # an arch's grad case and steps compile as one
        of, train = dict(ref_cases), {}
        for j, c in ref_cases:
            if c["kind"] in ("grad", "step"):
                key = (c["params"], json.dumps(c["more"], sort_keys=True), c["optimizer"])
                train.setdefault(key, []).append(j)
        merged = [js for js in train.values() if len(js) > 1]
        drop = {j for js in merged for j in js}
        by_mesh[m] = [(j, c) for j, c in ref_cases if j not in drop] + [
            (None, {**of[js[0]], "kind": "train",
                    "parts": [(j, of[j]["kind"], of[j]["accum"]) for j in js]}) for js in merged]
    meshes = [m for m in MESHES if by_mesh[m]]
    parts = [(m, by_mesh[m][j:j + ref_size]) for m in meshes
             for j in range(0, len(by_mesh[m]), ref_size)]
    refs = []
    try:
        for j, (m, part) in enumerate(parts):
            with open(tmp / f"cases{j}.pkl", "wb") as f:
                pickle.dump((part, {c["params"]: params[c["params"]] for _, c in part}), f)
            refs.append(torch_ranks.Reference(
                REFERENCE, [tmp / f"cases{j}.pkl", tmp / f"ref{j}.npz", json.dumps(list(m))],
                4, CHEAP_XLA, timeout=DEADLINE_S))
        ranks = torch_ranks.run_ranks(torch_ranks.lm_rank, 4, tmp, meshes, port_cases, params,
                                      timeout=DEADLINE_S)
        one = one_rank and torch_ranks.run_ranks(torch_ranks.one_rank_lm, 1, tmp, one_cases,
                                                 params)[0]
        for ref in refs:
            ref.wait()
    finally:
        for ref in refs:
            ref.kill()
    ref = {m: {} for m in meshes}
    for j, (m, _) in enumerate(parts):
        ref[m].update(np.load(tmp / f"ref{j}.npz"))
    shutil.rmtree(tmp, ignore_errors=True)  # a few hundred MB of arguments and results
    port = {m: [r[m] for r in ranks] for m in meshes}
    return port_cases, ref, port, one


def compare(i, c, ref, ranks, tols):
    """Each rank's blocks of case i against its block of `repro`'s whole
    outputs: {key: the largest relative error over the ranks}; asserts the
    step's AdamW rule on the updated params. `tols` (key prefix ->
    tolerance) is checked by the caller."""
    mesh = tuple(c["mesh"])
    amesh = AbstractMesh(mesh, axis_names(mesh))
    cell = build_cell(c["arch"], c["shape_name"], amesh, cfg=c["cfg"], shape=c["shape"],
                      accum=c["accum"], optimizer=c.get("optimizer", "adamw"))
    if c["kind"] == "grad":
        out_specs = (P(), cell.in_specs[0])
    elif c["kind"] == "decode":
        out_specs = (P(None, *cell.out_specs[0]), cell.out_specs[1])
    else:
        out_specs = cell.out_specs
    specs = flat(str(i), out_specs, {})
    assert len({r["coord"] for r in ranks}) == len(ranks)
    errs, n, n_far, n_codes, n_codes_off = {}, 0, 0, 0, 0
    for r in ranks:
        got = flat(str(i), r["out"], {})
        assert set(got) == set(specs), (sorted(got), sorted(specs))
        for key, spec in specs.items():
            whole = ref[key]
            blk = whole[block_slices(whole.shape, spec, amesh, r["coord"])]
            if c["kind"] == "step" and key.startswith(f"{i}/0/"):  # the updated params
                d = np.abs(blk.astype(np.float64) - got[key])
                assert d.max() <= 2 * LR, (key, d.max())
                n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
                continue
            g = np.asarray(got[key])
            assert g.shape == blk.shape, (key, g.shape, blk.shape)
            if whole.dtype == np.int8:  # adam8bit's codes: the rule of `A8_CODE_SHARE`
                d = np.abs(blk.astype(np.int64) - g)
                assert d.max() <= 1, (key, d.max())
                n_codes, n_codes_off = n_codes + d.size, n_codes_off + int((d > 0).sum())
                continue
            assert np.all(np.isfinite(g)), key
            scale = float(np.max(np.abs(whole)))
            errs[key] = max(errs.get(key, 0.0), float(np.max(np.abs(blk.astype(np.float64) - g))
                                                       / max(scale, 1e-30)))
    assert n_far <= ADAM_FLIP_SHARE * n, (n_far, n)
    assert n_codes_off <= A8_CODE_SHARE * n_codes, (n_codes_off, n_codes)
    bad = {k: e for k, e in errs.items()
           if e > next(t for p, t in tols if k.startswith(f"{i}/{p}"))}
    return errs, bad


CASES = ([(a, k, 1, m) for a in ALL_MESHES for m in MESHES for k in ("grad", "step")]
         + [(a, "step", 2, m) for a in ALL_MESHES for m in MESHES]
         + [(a, k, 1, (2, 2)) for a in ("chatglm", "command_r", "llama4")
            for k in ("grad", "step")])
# tolerance by output: the loss / metrics, the gradients, the moments
TOLS = {"grad": [("0", TOL), ("1/", GRAD_TOL)],
        "step": [("2/", TOL), ("1/", GRAD_TOL), ("0/", None)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("lm_ranks_train"), CASES, train_inputs, SHAPES)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_lm_train_across_ranks_matches_repro_on_the_same_mesh(case, runs):
    port_cases, ref, port, _ = runs
    c = port_cases[case]
    mesh = tuple(c["mesh"])
    at = sum(tuple(pc["mesh"]) == mesh for pc in port_cases[:case])  # its place on its mesh
    ranks = [r[at] for r in port[mesh]]
    errs, bad = compare(case, c, ref[mesh], ranks, TOLS[c["kind"]])
    print(json.dumps({"case": case_id(CASES[case]), "worst": max(errs.values())}))
    assert not bad, bad

