"""The LM trunk's serving cells across gloo ranks against `repro`'s jitted
cell functions on the same meshes, on the CPU.

As `test_torch_lm_ranks_train` (its archs, meshes, reduced configs,
harness and reference script): the prefill cell (8 sequences of 16
tokens; the weights in their serving layout, the tokens split by batch and
by sequence; last-position logits and both caches), 3 steps of the decode
cell from a filled cache of 64 positions (8 rows, whose positions start at
0, 3, 15, 16, 30, 40, 47 and 60: over 4 ranks of "model" the keys of the
row at 0 lie on one rank only, and the new keys of the rows at 15 and 47
cross into the next rank's block), and 3 steps of the long-context decode
(the long_500k cell's layout at 4,096 positions: batch 1, the cache split
over ("data", "model"), the C2 sparse attention with a window of 256 and
64 global samples, from position 2,046: the window spans two ranks'
blocks and the others hold no key that counts). Each step's logits and
the last caches are held to `repro`'s at 1e-5 of their largest |value|
(measured below 7e-6), but llama4's long-context decode at `TOL_AT`:
there jitted `repro` and `repro` run op by op (`jax.disable_jit`) part
by 2.7e-5 on the logits and 1.9e-5 on the caches themselves (measured;
XLA's fusions round otherwise), and the port's one-rank call is within
1.4e-6 of the op-by-op run. One spawn of one rank holds every kind's cell on
the (1, 1) mesh (the train step included) to the plain call, to the bit.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401
from repro_torch.configs.shapes import LMShape  # noqa: E402
from test_torch_lm_ranks_train import (  # noqa: E402
    ALL_MESHES, MESHES, SHAPES, TOL, _desc, case_id, compare, run_all, train_inputs)

B, S = 8, 16  # prefill
T, STEPS = 64, 3  # decode
POS = np.array([0, 3, 15, 16, 30, 40, 47, 60], np.int32)
LONG_T, LONG_POS = 4096, 2046
KINDS = ("prefill", "decode", "long")
TOL_AT = {("llama4", "long"): 5e-5}
SHAPES = {**SHAPES, "prefill": ("prefill_32k", LMShape("prefill_32k", S, B, "prefill")),
          "decode": ("decode_32k", LMShape("decode_32k", T, len(POS), "decode")),
          "long": ("long_500k", LMShape("long_500k", LONG_T, 1, "decode"))}


def serve_inputs(i, arch, kind):
    """A serving case's own whole args (the params come from the arch)."""
    over = _desc(arch)["over"]
    rng = np.random.default_rng(300 + i)
    if kind == "step":  # the one-rank train step
        return train_inputs(i, arch, kind)
    if kind == "prefill":
        return (rng.integers(0, over["vocab_size"], (B, S)).astype(np.int32),)
    batch, t = (1, LONG_T) if kind == "long" else (len(POS), T)
    shape = (over["n_layers"], batch, t, over["n_kv_heads"], over["head_dim"])
    cache = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, over["vocab_size"], (STEPS, batch)).astype(np.int32)
    pos = np.array([LONG_POS], np.int32) if kind == "long" else POS
    return cache, tokens, pos


CASES = ([(a, k, 1, m) for a in ALL_MESHES for m in MESHES for k in KINDS]
         + [(a, k, 1, (2, 2)) for a in ("chatglm", "command_r", "llama4") for k in KINDS])
ONE_RANK = [(a, k, 1, (1, 1)) for a in ("yi", "olmoe", "llama4")
            for k in ("step", "prefill", "decode", "long")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("lm_ranks_serve"), CASES, serve_inputs, SHAPES,
                   ONE_RANK, ref_size=8)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_lm_serve_across_ranks_matches_repro_on_the_same_mesh(case, runs):
    port_cases, ref, port, _ = runs
    c = port_cases[case]
    mesh = tuple(c["mesh"])
    at = sum(tuple(pc["mesh"]) == mesh for pc in port_cases[:case])  # its place on its mesh
    tol = TOL_AT.get(CASES[case][:2], TOL)
    errs, bad = compare(case, c, ref[mesh], [r[at] for r in port[mesh]], [("", tol)])
    print(json.dumps({"case": case_id(CASES[case]), "worst": max(errs.values())}))
    assert not bad, bad


@pytest.mark.parametrize("case", range(len(ONE_RANK)), ids=[case_id(c) for c in ONE_RANK])
def test_lm_cell_on_one_rank_is_the_plain_call_bit_for_bit(case, runs):
    assert runs[3][case]
