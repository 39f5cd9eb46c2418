"""adam8bit across gloo ranks, on the CPU.

- On shared gradients (`torch_ranks.adam8bit_rank`): three updates of each
  rank's blocks equal the one-rank update's blocks to the bit (updates,
  int8 codes and scales), on 2 ranks ((1, 2), (2, 1)) and 4 ((2, 2),
  (1, 4), (4, 1)). The params are laid out by the train cells' specs: the
  LM's FSDP layout (yi-shaped, d_ff 768, so that wo's and w_down's last
  axis of 512 is split over every rank: 128 columns a rank at 4, half of
  one of the blocks of 256, whose maxima the ranks exchange) and its
  Megatron one
  (`train_layout="tp"`: w_gate's and w_up's columns over "model"), and
  taobao_ssa's and DIN's tables split by rows. The tables' last axis is
  never split (`split_last` is False for every leaf): a rank holds whole
  blocks, and its update reads nothing of another rank.
- taobao_ssa's adam8bit train cell on (1, 4) and (2, 2) against `repro`'s
  jitted cell on the same mesh (`test_torch_recsys_ranks`' reference and
  inputs): the metrics 1e-5 of each one's |value|, the updated params
  AdamW's first-step rule (`test_torch_optimizer`; adam8bit's first step
  from zero moments is AdamW's), the moments' scales `TRAIN_TOL` of their
  leaf's largest, their codes within one step in at most `A8_CODE_SHARE`
  of them (the rule of `repro`'s jitted update on shared gradients,
  `test_torch_optimizer`; the two packages' gradients differ in their last
  bits).
"""
import dataclasses
import json
import pickle

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.configs.shapes import RecSysShape  # noqa: E402
from repro_torch.distributed.sharding import block_slices  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axis_names  # noqa: E402
from repro_torch.models.common import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.training.optimizer import adam8bit  # noqa: E402
from test_torch_expert_parallel_ranks import CHEAP_XLA  # noqa: E402
from test_torch_lm_ranks_train import A8_CODE_SHARE, port_cfg, _desc  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE  # noqa: E402
from test_torch_recsys_ranks import (  # noqa: E402
    _REFERENCE, B, LR, TRAIN_TOL, _batch, _desc as rec_desc, _flat, _params, _port_cfg)

WORLDS = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4), (4, 1))}
SHARED = [("yi_6b", "train_4k", port_cfg(_desc("yi"), d_ff=768)),
          ("yi_6b", "train_4k", port_cfg(_desc("yi"), train_layout="tp")),
          ("taobao_ssa", "train_batch", _port_cfg(rec_desc("taobao_ssa", ""))),
          ("din", "train_batch", _port_cfg(rec_desc("din", "")))]
CELL_MESHES = ((1, 4), (2, 2))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adam8bit_ranks")
    cases = [{"arch": a, "shape_name": s, "cfg": c, "seed": i}
             for i, (a, s, c) in enumerate(SHARED)]
    return {world: torch_ranks.run_ranks(torch_ranks.adam8bit_rank, world, tmp, meshes, cases)
            for world, meshes in WORLDS.items()}


@pytest.mark.parametrize("mesh", [m for ms in WORLDS.values() for m in ms],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("case", range(len(SHARED)),
                         ids=[f"{a}-{c.train_layout}" if a == "yi_6b" else a for a, _, c in SHARED])
def test_update_on_shared_gradients_is_the_one_rank_updates_block_bit_for_bit(case, mesh,
                                                                              shared):
    ranks = [r[mesh][case] for r in shared[mesh[0] * mesh[1]]]
    assert len({r["coord"] for r in ranks}) == mesh[0] * mesh[1]
    for r in ranks:
        assert all(r["same"].values()), [k for k, v in r["same"].items() if not v]
    split = {k for k, v in ranks[0]["split_last"].items() if v}
    arch, _, cfg = SHARED[case]
    if arch != "yi_6b":  # row-split tables and replicated towers: whole blocks
        assert not split, split
    elif cfg.train_layout == "tp":  # Megatron's column blocks, where "model" has ranks
        assert split == ({"ffn/w_gate", "ffn/w_up"} if mesh[1] > 1 else set()), split
    else:  # FSDP: the last axis over every rank where the first dims do not divide
        assert split == {"attn/wo", "ffn/w_down"}, split


def _a8_inputs(arch, seed):
    cfg = _port_cfg(rec_desc(arch, ""))
    params, _ = _params(arch, "")
    batch = _batch(cfg, B, np.random.default_rng(500 + seed), label=True)
    state = to_numpy_tree(adam8bit(1e-4).init(from_numpy_tree(params, "cpu")))
    return cfg, (params, state, batch)


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    """taobao_ssa's adam8bit train cell through `repro` (a subprocess a
    mesh) and the port (4 gloo ranks, both meshes in one spawn)."""
    tmp = tmp_path_factory.mktemp("adam8bit_cell")
    cfg, args = _a8_inputs("taobao_ssa", 0)
    shape = RecSysShape("train_batch", B, "train")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump([{"desc": rec_desc("taobao_ssa", ""), "kind": "step", "args": args,
                      "shape": dataclasses.asdict(shape), "optimizer": "adam8bit"}], f)
    refs = [torch_ranks.Reference(_REFERENCE, [tmp / "cases.pkl", tmp / f"ref{m}.npz",
                                               json.dumps(list(mesh))], 4, CHEAP_XLA)
            for m, mesh in enumerate(CELL_MESHES)]
    try:
        ranks = torch_ranks.run_ranks(torch_ranks.recsys_rank, 4, tmp, CELL_MESHES, [
            {"arch": "taobao_ssa", "shape_name": "train_batch", "shape": shape, "cfg": cfg,
             "kind": "step", "args": args, "optimizer": "adam8bit"}])
        for ref in refs:
            ref.wait()
    finally:
        for ref in refs:
            ref.kill()
    return cfg, shape, {mesh: dict(np.load(tmp / f"ref{m}.npz"))
                        for m, mesh in enumerate(CELL_MESHES)}, ranks


@pytest.mark.parametrize("mesh", CELL_MESHES, ids=lambda m: "x".join(map(str, m)))
def test_taobao_ssa_adam8bit_step_across_ranks_matches_repro(mesh, cell_runs):
    cfg, shape, ref, ranks = cell_runs
    amesh = AbstractMesh(mesh, axis_names(mesh))
    cell = build_cell("taobao_ssa", "train_batch", amesh, cfg=cfg, shape=shape,
                      optimizer="adam8bit")
    specs = _flat("0", cell.out_specs, {})
    n, n_far, n_codes, n_off, worst = 0, 0, 0, 0, {}
    for r in (rank[mesh][0] for rank in ranks):
        got = _flat("0", r["out"], {})
        assert set(got) == set(specs)
        for key, spec in specs.items():
            whole = ref[mesh][key]
            blk = whole[block_slices(whole.shape, spec, amesh, r["coord"])]
            d = np.abs(blk.astype(np.float64) - np.asarray(got[key], np.float64))
            if key.startswith("0/0/"):  # the updated params
                assert d.max() <= 2 * LR, (key, d.max())
                n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
            elif whole.dtype == np.int8:  # the moments' codes
                assert d.max() <= 1, (key, d.max())
                n_codes, n_off = n_codes + d.size, n_off + int((d > 0).sum())
            else:  # scales, the count and the metrics
                worst[key] = max(worst.get(key, 0.0),
                                 float(d.max()) / max(float(np.abs(whole).max()), 1e-30))
    print(json.dumps({"mesh": mesh, "worst": max(worst.values()), "codes_off": n_off,
                      "codes": n_codes}))
    assert n_far <= ADAM_FLIP_SHARE * n, (n_far, n)
    assert n_off <= A8_CODE_SHARE * n_codes, (n_off, n_codes)
    assert max(worst.values()) <= TRAIN_TOL, worst
