"""The LM cells' other layouts across gloo ranks against `repro`'s jitted cell
functions on the same meshes, on the CPU.

`test_torch_lm_ranks_train`'s harness (`run_all`, `compare`, its reduced
configs and its `repro` subprocesses on 4 forced CPU devices), with a
variant of the config a case (`VARIANTS`):

- yi-shaped `train_layout="tp"` (`repro`'s Megatron experiment: the
  serving layout's weights in the train step, tokens split by batch only):
  the loss with every gradient leaf and the AdamW step, on (2, 2) and
  (1, 4);
- yi-shaped `int8_serve`: the prefill, decode and long-context decode
  cells on int8 `{"q","s"}` weights and tables (`int8_params`: codes and
  scales from a seed), on (2, 2) and (1, 4);
- olmoe-shaped and llama4-shaped (a shared expert) `moe_impl="gspmd"`:
  the loss and gradients, the AdamW step (whose metrics carry aux) and the
  prefill, on (2, 2) and (4, 1); olmoe also at capacity factor 0.5
  (`DROP_CF`), where entries drop (`test_entries_drop_where_the_capacity_is_cut`),
  on (2, 2);
- a yi-shaped adam8bit step on (1, 4) and (2, 2) at d_ff 768, where the
  FSDP layout splits w_down's last axis (512) 4 ways: a rank holds 128
  columns, half of one of adam8bit's blocks of 256;
- olmoe's step under `moe_impl="ep"` on (2, 2), whose aux is the mean of
  each shard's (`test_gspmd_aux_is_the_whole_batchs_not_the_shards_mean`);
- MoE under `train_layout="tp"`: olmoe's and llama4's loss, gradients and
  step through `moe_ffn_ep` (every rank of "model" dispatching the same
  tokens, as `repro`'s shard_map over x's spec without "model" does) on
  (2, 2) and (1, 4), and olmoe's under `moe_impl="gspmd"` on (2, 2).

Tolerances are those in force (`test_torch_lm_ranks_train`): the loss and
metrics 1e-5 of the largest |value|, gradients and moments `GRAD_TOL`,
the updated params AdamW's rule, prefill and decode outputs 1e-5, and
adam8bit's codes within one step in at most `A8_CODE_SHARE` of them. The
int8 cells are held to jitted `repro` at `INT8_JIT_TOL`: `repro`'s `_mm`
rounds the dequantized weight to bf16 and XLA drops that f32 -> bf16 ->
f32 round trip under `jit` (`test_torch_transformer`'s int8 case: 3.3e-3
to 8.5e-3 at one device, where the port is held to `repro` run op by op
at 1e-5); measured here 1.9e-3 to 2.7e-3. Each rank's int8 blocks are
held at 1e-5 to the port's one-rank call on the whole params, which keeps
`repro`'s bf16 rounding (`test_int8_blocks_are_the_one_rank_calls`).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.distributed.sharding import P, block_slices  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axis_names  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import from_numpy_tree  # noqa: E402
from test_torch_lm_ranks_serve import SHAPES, serve_inputs  # noqa: E402
from test_torch_lm_ranks_train import (  # noqa: E402
    GRAD_TOL, TOL, _desc, case_id, compare, flat, params_for, port_cfg, run_all, train_inputs)

DROP_CF = 0.5
INT8_JIT_TOL = 1e-2
VARIANTS = {"tp": ({"train_layout": "tp"}, "adamw"),
            "int8": ({"int8_serve": True}, "adamw"),
            "gspmd": ({"moe_impl": "gspmd"}, "adamw"),
            "drop": ({"moe_impl": "gspmd", "capacity_factor": DROP_CF}, "adamw"),
            "a8": ({"d_ff": 768}, "adam8bit"),
            "tpg": ({"train_layout": "tp", "moe_impl": "gspmd"}, "adamw")}
MODEL_SPLIT = ((2, 2), (1, 4))  # "model" over 2 and 4 ranks
CASES = ([("yi", f"tp:{k}", 1, m) for m in MODEL_SPLIT for k in ("grad", "step")]
         + [("yi", f"int8:{k}", 1, m) for m in MODEL_SPLIT for k in ("prefill", "decode", "long")]
         + [(a, f"gspmd:{k}", 1, m) for a in ("olmoe", "llama4") for m in ((2, 2), (4, 1))
            for k in ("grad", "step", "prefill")]
         + [("olmoe", f"drop:{k}", 1, (2, 2)) for k in ("grad", "step", "prefill")]
         + [("yi", "a8:step", 1, m) for m in ((1, 4), (2, 2))]
         + [("olmoe", "step", 1, (2, 2))]
         + [(a, f"{v}:{k}", 1, m) for a, v, m in (("olmoe", "tp", (2, 2)), ("llama4", "tp", (1, 4)),
                                                  ("olmoe", "tpg", (2, 2)))
            for k in ("grad", "step")])
TOLS = {"grad": [("0", TOL), ("1/", GRAD_TOL)],
        "step": [("2/", TOL), ("1/", GRAD_TOL), ("0/", None)]}


def inputs(i, arch, kind):
    return train_inputs(i, arch, kind) if kind in ("grad", "step") else serve_inputs(i, arch, kind)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("lm_ranks_layouts"), CASES, inputs, SHAPES,
                   variants=VARIANTS)


def _place(port_cases, case):
    mesh = tuple(port_cases[case]["mesh"])
    return mesh, sum(tuple(pc["mesh"]) == mesh for pc in port_cases[:case])


@pytest.mark.parametrize("case", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_layout_across_ranks_matches_repro_on_the_same_mesh(case, runs):
    port_cases, ref, port, _ = runs
    c = port_cases[case]
    mesh, at = _place(port_cases, case)
    tols = [("", INT8_JIT_TOL)] if c["cfg"].int8_serve else TOLS.get(c["kind"], [("", TOL)])
    errs, bad = compare(case, c, ref[mesh], [r[at] for r in port[mesh]], tols)
    print(json.dumps({"case": case_id(CASES[case]), "worst": max(errs.values())}))
    assert not bad, bad


INT8 = [i for i, c in enumerate(CASES) if c[1].startswith("int8:")]


@pytest.mark.parametrize("case", INT8, ids=[case_id(CASES[i]) for i in INT8])
def test_int8_blocks_are_the_one_rank_calls(case, runs):
    """Each rank's outputs of an int8 cell against its block of the port's
    plain call on the whole params and inputs: within 1e-5 of the largest
    |value| (the row-parallel products sum their partial products in
    another order)."""
    port_cases, _, port, _ = runs
    c = port_cases[case]
    mesh, at = _place(port_cases, case)
    params = from_numpy_tree(params_for(c["params"]), "cpu")
    args = [torch_ranks._tensors(a) for a in c["args"]]
    with torch.no_grad():
        if c["kind"] == "prefill":
            one = transformer.prefill(params, args[0], c["cfg"])
        else:
            cache, tokens, pos = args
            logits = []
            for t in range(tokens.shape[0]):
                lg, cache = transformer.decode(params, cache, tokens[t], pos + t, c["cfg"])
                logits.append(lg)
            one = (torch.stack(logits), cache)
    amesh = AbstractMesh(mesh, axis_names(mesh))
    cell = build_cell(c["arch"], c["shape_name"], amesh, cfg=c["cfg"], shape=c["shape"])
    specs = ((cell.out_specs[0] if c["kind"] == "prefill" else P(None, *cell.out_specs[0])),
             cell.out_specs[1])
    worst = 0.0
    for r in port[mesh]:
        got = r[at]
        for key, spec in flat("", specs, {}).items():
            whole = flat("", torch_ranks._numpy_tree(one), {})[key]
            blk = whole[block_slices(whole.shape, spec, amesh, got["coord"])]
            err = np.abs(flat("", got["out"], {})[key] - blk).max() / np.abs(whole).max()
            worst = max(worst, float(err))
    print(json.dumps({"case": case_id(CASES[case]), "worst_vs_one_rank": worst}))
    assert worst <= TOL


def test_gspmd_aux_is_the_whole_batchs_not_the_shards_mean(runs):
    """On the (2, 2) mesh, on the same tokens, `moe_impl="gspmd"`'s aux is
    the whole batch's (`moe_ffn`), `"ep"`'s the mean of each shard's
    (`moe_ffn_ep`'s `pmean`): each equals `repro`'s own, and they differ."""
    port_cases, ref, port, _ = runs
    aux = {}
    for case, c in enumerate(CASES):
        if c[0] == "olmoe" and c[1] in ("gspmd:step", "step") and c[3] == (2, 2):
            mesh, at = _place(port_cases, case)
            got = {float(r[at]["out"][2]["aux"]) for r in port[mesh]}
            assert len(got) == 1, got  # every rank returns the same aux
            want = float(ref[mesh][f"{case}/2/aux"])
            assert abs(got.pop() - want) <= TOL * abs(want)
            aux[c[1]] = want
    assert abs(aux["gspmd:step"] - aux["step"]) > 100 * TOL * abs(aux["step"]), aux


@pytest.mark.parametrize("variant,dropped", [("gspmd", None), ("drop", True)])
def test_entries_drop_where_the_capacity_is_cut(variant, dropped):
    """The prefill inputs of olmoe's cases, on one rank: at `DROP_CF` the
    whole batch's dispatch drops entries in every layer (the cases above
    hold those drops against `repro`); at the config's 1.25 the count is
    recorded."""
    case = next(i for i, c in enumerate(CASES) if c[:2] == ("olmoe", f"{variant}:prefill"))
    cfg = port_cfg(_desc("olmoe"), **VARIANTS[variant][0])
    params = from_numpy_tree(params_for("olmoe_1b_7b"), "cpu")
    stats = {}
    with torch.no_grad():
        transformer.prefill(params, torch.from_numpy(serve_inputs(case, "olmoe", "prefill")[0]),
                            cfg, stats)
    drops = [int(d) for d in stats["dropped"]]
    print(json.dumps({"variant": variant, "dropped_per_layer": drops}))
    assert len(drops) == cfg.n_layers
    if dropped:
        assert all(d > 0 for d in drops), drops
