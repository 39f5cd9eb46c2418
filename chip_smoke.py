#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments: it puts `src` on
`sys.path` itself and imports nothing of JAX or of the `repro` package.
Phases, one JSON line each:

1. device  — `nvidia-smi` name and power limit, torch / CUDA versions, TF32
   switched off (the reference is full f32). No card: it raises.
2. build   — every `src/repro_torch/csrc/*.cu` compiled by nvcc, one
   process per source started together (or found in the build cache),
   with the seconds it took.
3. kernels — each kernel's wrapper on card tensors at the main paths'
   shapes, held against its plain PyTorch version on the same inputs, and
   timed beside its bound, the plain version and, where one exists, one
   PyTorch library call: embedding_bag at taobao_ssa's, FM's and DIEN's
   lookups, fm_interaction at FM's B=512, augru at DIEN's B=512, a ragged
   B, one row and the benchmark's 4096 (launched twice for the same bits),
   block_pruned_matmul at every masked linear of a structured
   taobao_ssa serve call of 512 requests and at densities 0 and 1 (also
   against an f64 product, and launched twice for the same bits),
   local_attention at the C2 ranker's call of 512 requests (BH 2048,
   L 100, dh 16, window 32, the history key mask), on contiguous tensors
   and on the encoder's views of [B, L, H, dh] projections, and at ragged,
   causal, bf16, dh 32/64/128 and no-valid-key cases (each launched twice,
   and on contiguous copies, for the same bits), int8_matmul at the ranker's
   FFN w1 (51,200 x 64 x 256), at 512³ and at ragged shapes (int32
   accumulators equal to the plain version's).
4. ladder  — taobao_ssa at full width from seed 0: the launcher's
   pretraining (40 AdamW steps on batches of 256), then `run_ladder` with
   `LadderConfig(structured=True)` at the launcher's 10/10/15 steps; the
   losses (finite; falling in pretraining), each stage's seconds, the
   kernels' launches in training (exact), `variant_stats`. The
   pretraining runs twice from the same start and must end in the same
   bits (every gradient on the card sums in a fixed order).
5. train vs CPU — one `make_train_step` from the same pretrained
   parameters and batch on the card and on the CPU, on the dense tree and
   on a structured-masked one (with its block masks), with AdamW and with
   SGD at lr 1: every updated leaf, tables and masks included, within the
   stated tolerance. This holds the gradients through the kernels.
Then, for each ported arch in turn (taobao_ssa, fm, dien), at full width,
its parameters freed before the next (taobao_ssa: the ladder's five
trained variants; fm and dien: random weights from seed 0):
6. serve   — the arch's variants (taobao_ssa: all five; fm: `baseline`
   and `quantized`; dien: `baseline`) at 1/8/32/128/512 requests through
   `repro_torch.launch.serve`; every kernel's launch count is reset just
   before and read just after, and must match `EXPECT_LAUNCHES`.
7. profile — serve calls' device busy time and each kernel's share
   (torch.profiler), every variant at 512 and baseline at 1; the idle
   share sets that busy time against the serve phase's unprofiled median,
   since the profiler slows the host.
8. card vs CPU — the same parameters and one 512-request batch through
   `serve` on the card and on the CPU's plain path, every variant.
Then two more paths, each with its launches counted from 0:
9. serve_taobao_ssa_c2 — taobao_ssa under the paper's C2 window of 32
   through `serve.run`: pretraining, the structured ladder, the five
   variants at every size; launches per call and in all (training's and
   serving's, worked out); then card vs CPU on baseline and quantized, a
   window of L = 100 against full attention, a profile at 1 and 512.
10. bench_kernels — `python -m repro_torch.launch.bench_kernels`'s six
   rows, every kernel at `benchmarks/bench_kernels.py`'s shapes.

Then the `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Any failure raises and the exit code is
not 0; nothing is caught and passed over.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import PORTED, get_config, with_attn_window  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core.compression_loop import run_ladder, serving_params, variant_stats  # noqa: E402
from repro_torch.core.quantization import quantize_weight  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.augru import augru as augru_kernel  # noqa: E402
from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import block_pruned_matmul as bpm_kernel  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.launch import bench_kernels, serve  # noqa: E402
from repro_torch.launch.bench_kernels import bound, time_ms  # noqa: E402
from repro_torch.launch.train import make_data  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.training.optimizer import adamw, sgd  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402

SIZES = (1, 8, 32, 128, 512)
SERVE_REPS = 20
PROFILE_CALLS = 10
PROB_TOL = 1e-5  # card vs CPU, on probabilities
FM_RTOL, FM_ATOL = 1e-4, 1e-3  # the JAX kernel test's: (Σe)² − Σe² cancels
AUGRU_TOL = 1e-5  # absolute: h lies in (-1, 1)
# train vs CPU, from parameters that the card's pretraining gives bit for
# bit in every run (its table gradients sum in batch order). SGD at lr 1
# without momentum: the update u is the clipped gradient. Where no ReLU or
# PReLU input lies within rounding of 0 the two devices agree to ~1e-6 of
# a leaf's largest |u| (measured from seed 0: 2.5e-5 of a leaf's norm);
# where one does, that unit takes the other branch on the other device
# and moves its tokens' gradients, through attention every token of the
# sequence and the table rows they read (measured on other parameters: up
# to 317 elements of a leaf, 2e-3 of its largest |u|). A missing or wrong
# gradient moves the whole leaf. So: |Δ| ≤ 10% of the leaf's largest |u|
# everywhere and ‖Δ‖₂ ≤ 1% of ‖u‖₂. AdamW's first step is
# -lr·g/(|g|+1e-8), about lr for every element with a gradient, whose slope
# lr·1e-8/(|g|+1e-8)² turns the last-bit difference of a gradient that
# cancels to ~1e-7 into up to 2·lr. A missing update gives ‖Δ‖₂ = ‖u‖₂, a
# wrong sign 2‖u‖₂. So: ‖Δ‖₂ ≤ 20% of ‖u‖₂ (measured from seed 0: 2.2e-4),
# and an element may differ by more than 1e-6 only where its gradient is
# below 1e-3 of its leaf's largest, with at most 1% of the elements the
# CPU's step moved excepted.
TRAIN_SGD_MAX_REL, TRAIN_SGD_NORM_REL = 0.1, 1e-2
TRAIN_ADAM_NORM_REL = 0.2
TRAIN_ADAM_ATOL, TRAIN_ADAM_SMALL_GRAD, TRAIN_ADAM_SHARE = 1e-6, 1e-3, 1e-2
GRAD_NORM_REL = 1e-4
LOSS_REL = 1e-5
LADDER = dataclasses.replace(serve.LADDER, structured=True)

# kernel launches per serve call, by (arch, variant); quantized tables are
# int8, gathered in plain torch; a structured ladder's 15 masked linears
# (wq, wk, wv, wo, w1, w2 of two blocks; the tower's three) run the
# block-pruned kernel, the student's low-rank and grouped ones do not;
# under the C2 window ("taobao_ssa_c2") each encoder block's attention runs
# the local-attention kernel (two blocks, one in the distilled student)
_NONE = {k: 0 for k in serve.KERNELS}
_SSA = {"baseline": {"embedding_bag": 5}, "quantized": {},
        "pruned": {"embedding_bag": 5, "block_pruned_matmul": 15},
        "pruned_quantized": {"block_pruned_matmul": 15}, "distilled": {"embedding_bag": 5}}
EXPECT_LAUNCHES = {
    **{("taobao_ssa", v): {**_NONE, **n} for v, n in _SSA.items()},
    **{("taobao_ssa_c2", v): {**_NONE, **n, "local_attention": 1 if v == "distilled" else 2}
       for v, n in _SSA.items()},
    ("fm", "baseline"): {**_NONE, "embedding_bag": 2, "fm_interaction": 1},
    ("fm", "quantized"): {**_NONE, "fm_interaction": 1},
    ("dien", "baseline"): {**_NONE, "embedding_bag": 5, "augru": 1},
}
C2_WINDOW = 32  # the C2 path's window: a third of L = 100
KERNEL_SYMBOL = {"embedding_bag": "embedding_bag_kernel",
                 "fm_interaction": "fm_interaction_kernel", "augru": "augru_kernel",
                 "block_pruned_matmul": "block_pruned_matmul_",  # tall, small and rows
                 "local_attention": "local_attention_kernel", "int8_matmul": "int8_matmul_kernel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    serve.disable_tf32()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    rep = _build.build_all()
    for name, text in rep["ptxas"].items():
        print(f"[nvcc {name}]\n{text}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": rep["seconds"], "built": rep["built"],
          "cached": rep["cached"], "cache_hit": not rep["built"]})


def _bag_case(name, V, d, vocab, B, nnz, weighted, gen, flush):
    """One shape: ids drawn from the `vocab` real rows of a padded [V, d]
    table, through `bench_kernels.embedding_bag_case`."""
    dev = torch.device("cuda")
    table = torch.randn((V, d), generator=gen, device=dev)
    idx = torch.randint(0, vocab, (B, nnz), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((B, nnz), generator=gen, device=dev) if weighted else None
    return {"shape": name, "table": [V, d], "B": B, "nnz": nnz, "weighted": weighted,
            **bench_kernels.embedding_bag_case(table, idx, w, flush=flush)}


def _embedding_bag_kernel(gen, flush) -> dict:
    # full-width padded tables and the ids a 512-request serve call looks up
    fm_rows, fm_vocab = 33_763_840, 33_763_409
    cases = [
        _bag_case("taobao_item_hist_nnz1", 200_192, 64, 200_000, 512 * 100, 1, False, gen, flush),
        _bag_case("taobao_user_nnz1", 1_000_448, 16, 1_000_000, 512, 1, False, gen, flush),
        _bag_case("item_bag_nnz100", 200_192, 64, 200_000, 512, 100, True, gen, flush),
        _bag_case("fm_first_order_nnz39", fm_rows, 1, fm_vocab, 512, 39, False, gen, flush),
        _bag_case("fm_unified_nnz1", fm_rows, 10, fm_vocab, 512 * 39, 1, False, gen, flush),
        _bag_case("dien_item_hist_nnz1", 50_000_384, 18, 50_000_000, 512 * 100, 1, False, gen,
                  flush),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "embedding_bag", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"embedding_bag disagrees with its plain version at {bad}")
    head = cases[0]  # taobao_ssa's largest lookup: 51,200 ids into the item table
    return {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:37",
        "launches": None, "ok": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "vs_library": head["vs_library"], "at": head["shape"], "shapes": cases,
    }


def _fm_interaction_kernel(gen, flush) -> dict:
    dev = torch.device("cuda")
    F_, k = 39, 10
    checks = []
    for B in (512, 37):
        e = torch.randn((B, F_, k), generator=gen, device=dev)
        out, ref = fm_ops.fm_interaction_op(e), fm_interaction_ref(e)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=FM_RTOL, atol=FM_ATOL))
        checks.append({"B": B, "ok": ok, "max_abs_err": err})
        emit({"phase": "kernels", "kernel": "fm_interaction", "B": B, "F": F_, "k": k, "ok": ok,
              "max_abs_err": err, "rtol": FM_RTOL, "atol": FM_ATOL})
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"fm_interaction disagrees with its plain version: {checks}")
    B = 512
    e = torch.randn((B, F_, k), generator=gen, device=dev)
    ms = time_ms(lambda: fm_ops.fm_interaction_op(e), flush)
    plain_ms = time_ms(lambda: fm_interaction_ref(e), flush)
    # per value: s += v, q += v·v (3); per factor: S², −, Σ (3); per example: ½ (1)
    work = bound(4 * B * F_ * k + 4 * B, B * (3 * F_ * k + 3 * k + 1))
    rec = {"name": "fm_interaction", "route": "cuda",
           "source": "src/repro_torch/csrc/fm_interaction.cu",
           "replaces": "src/repro/kernels/fm_interaction/fm_interaction.py:25",
           "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
           "bound_by": work["bound_by"], "library_ms": None,
           "library_none": "no single PyTorch call computes the FM sum-square interaction",
           "at": f"B={B} F={F_} k={k}", "bytes": work["bytes"], "flops": work["flops"],
           "checks": checks}
    emit({"phase": "kernels", "kernel": "fm_interaction", **rec})
    return rec


def _augru_inputs(B, T, g, gen):
    """DIEN-like inputs: zx of unit scale, wh at fan-in scale, attention
    weights that sum to 1 over a prefix of random length, h0 = 0."""
    dev = torch.device("cuda")
    zx = torch.randn((B, T, 3 * g), generator=gen, device=dev)
    wh = torch.randn((g, 3 * g), generator=gen, device=dev) / g ** 0.5
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    mask = torch.arange(T, device=dev)[None] < lens[:, None]
    logits = torch.where(mask, torch.randn((B, T), generator=gen, device=dev), -1e30)
    att = torch.softmax(logits, dim=-1)
    return zx, wh, torch.zeros((B, g), device=dev), att, mask


def _augru_kernel(gen, flush) -> dict:
    T, g = 100, 108
    checks = []
    for B in (512, 37, 1, 4096):  # DIEN's serve call, ragged, one row, the benchmark's
        args = _augru_inputs(B, T, g, gen)
        out, again, ref = augru_ops.augru_op(*args), augru_ops.augru_op(*args), augru_ref(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bit_equal = bool(torch.equal(out, again))
        ok = err <= AUGRU_TOL and bit_equal
        plan = augru_kernel.launch_plan(B, g, bpm_kernel.sm_count(out.device))._asdict()
        checks.append({"B": B, "ok": ok, "max_abs_err": err, "bit_equal": bit_equal})
        emit({"phase": "kernels", "kernel": "augru", "B": B, "T": T, "g": g, "ok": ok,
              "max_abs_err": err, "tol": AUGRU_TOL, "bit_equal": bit_equal, "plan": plan})
        del args, out, again, ref
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"augru disagrees with its plain version or repeats in other "
                             f"bits: {checks}")
    B = 512
    args = _augru_inputs(B, T, g, gen)
    ms = time_ms(lambda: augru_ops.augru_op(*args), flush)
    plain_ms = time_ms(lambda: augru_ref(*args), flush, iters=10)
    # per row and step: h @ wh (2·g·3g) and 16 elementwise ops per unit
    # (r, u: add + exp + add + div each; c: mul, add, tanh; a·u; 1−u, ·h, u·c, +)
    nbytes = 4 * B * T * 3 * g + 4 * g * 3 * g + 4 * B * g + 4 * B * T + B * T + 4 * B * g
    work = bound(nbytes, B * T * (6 * g * g + 16 * g))
    rec = {"name": "augru", "route": "cuda", "source": "src/repro_torch/csrc/augru.cu",
           "replaces": "src/repro/kernels/augru/augru.py:48",
           "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
           "bound_by": work["bound_by"], "library_ms": None,
           "library_none": ("torch.nn.GRU / cuDNN compute a GRU without the attentional "
                            "update gate, another function"),
           "at": f"B={B} T={T} g={g}", "bytes": work["bytes"], "flops": work["flops"],
           "checks": checks}
    emit({"phase": "kernels", "kernel": "augru", **rec})
    return rec


def _bpm_case(name, M, K, N, block_mask, gen, flush, alt_plans=None):
    """One masked linear: x [M,K] @ (w ⊙ expand(block_mask)), w at fan-in
    scale, through `bench_kernels.block_pruned_matmul_case`."""
    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
    bm = torch.tensor(block_mask, dtype=torch.int32, device=dev)
    return {"shape": name, "M": M, "K": K, "N": N, "block_mask": block_mask,
            **bench_kernels.block_pruned_matmul_case(x, w, bm, flush=flush, alt_plans=alt_plans)}


def _block_pruned_matmul_kernel(gen, flush) -> dict:
    tokens = 512 * 100  # a serve call of 512 requests: B·L rows through the encoder
    # the tower's 80 x 1 output takes the rows path (N < 8); the small
    # tensor-core tile is timed beside it
    small = bpm_kernel.Plan(3, 16, 16)
    cases = [
        _bpm_case("enc_proj_64x64", tokens, 64, 64, [[1]], gen, flush),
        _bpm_case("enc_w1_64x256_d0.5", tokens, 64, 256, [[1, 0]], gen, flush),
        _bpm_case("enc_w2_256x64_d0.5", tokens, 256, 64, [[1], [0]], gen, flush),
        _bpm_case("tower_w0_208x200", 512, 208, 200, [[1, 1], [1, 0]], gen, flush),
        _bpm_case("tower_w1_200x80", 512, 200, 80, [[1], [0]], gen, flush),
        _bpm_case("tower_wout_80x1", 512, 80, 1, [[1]], gen, flush,
                  alt_plans={"small_32x32": small}),
        _bpm_case("dense_256_d0", 256, 256, 256, [[0, 0], [0, 0]], gen, flush),
        _bpm_case("dense_256_d1", 256, 256, 256, [[1, 1], [1, 1]], gen, flush),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "block_pruned_matmul", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"block_pruned_matmul disagrees with its plain version or the f64 "
                             f"product, or repeats in other bits, at {bad}")
    head = cases[1]  # the widest masked linear of the serve path: 51,200 x 64 x 256 at 0.5
    return {
        "name": "block_pruned_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/block_pruned_matmul.cu",
        "replaces": "src/repro/kernels/block_pruned_matmul/block_pruned_matmul.py:45",
        "launches": None, "ok": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_f64_ratio": max(c["f64_ratio"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "bound_peak": head["bound_peak"],
        "bound_ms_f32_cores": head["bound_ms_f32_cores"], "library_ms": head["library_ms"],
        "library_call": "torch.matmul(x, w * mask), TF32 off", "vs_library": head["vs_library"],
        "at": head["shape"], "shapes": cases,
    }


def _la_case(name, B, H, L, dh, window, gen, flush, *, causal=False, kv_len=None,
             dtype=torch.float32, timed=False, views=False):
    """One shape of the windowed attention: q, k, v normal, `kv_len` [B] or
    None, through `bench_kernels.local_attention_case` (bf16 inputs against
    the f32 plain version of the same rounded inputs). `views`: q, k and v
    are `transpose(1, 2)` views of [B, L, H, dh] tensors, as the taobao_ssa
    encoder hands them over."""
    shape = (B, L, H, dh) if views else (B, H, L, dh)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    if views:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    rec = bench_kernels.local_attention_case(q, k, v, window=window, causal=causal,
                                             kv_len=kv_len, flush=flush if timed else None)
    return {"shape": name, "B": B, "H": H, "L": L, "dh": dh, "views": views, **rec}


def _local_attention_kernel(gen, flush) -> dict:
    dev = torch.device("cuda")
    B = 512
    hist = torch.randint(25, 101, (B,), generator=gen, device=dev, dtype=torch.int32)  # taobao's
    ragged = torch.tensor([0, 1, 2, 25, 31, 32, 33, 99, 100] * 4 + [7], dtype=torch.int32,
                          device=dev)
    cases = [
        # the C2 ranker's call at 512 requests: every encoder block's attention
        _la_case("ranker_512", B, 4, 100, 16, C2_WINDOW, gen, flush, kv_len=hist, timed=True),
        # the same call as the encoder makes it: views of [B, L, H, dh] projections
        _la_case("ranker_512_views", B, 4, 100, 16, C2_WINDOW, gen, flush, kv_len=hist,
                 timed=True, views=True),
        _la_case("ranker_bf16_views", 37, 4, 100, 16, C2_WINDOW, gen, flush, kv_len=ragged,
                 dtype=torch.bfloat16, views=True),
        _la_case("ranker_ragged_kv0", 37, 4, 100, 16, C2_WINDOW, gen, flush, kv_len=ragged),
        _la_case("ranker_window_1", 37, 4, 100, 16, 1, gen, flush, kv_len=ragged),
        _la_case("ranker_window_L", 37, 4, 100, 16, 100, gen, flush, kv_len=ragged),
        _la_case("ranker_bf16", 37, 4, 100, 16, C2_WINDOW, gen, flush, kv_len=ragged,
                 dtype=torch.bfloat16),
        _la_case("causal_dh32", 2, 3, 200, 32, 64, gen, flush, causal=True),
        _la_case("bench_dh64", 8, 1, 2048, 64, 256, gen, flush),
        _la_case("dh128_bf16_causal", 2, 2, 300, 128, 50, gen, flush, causal=True,
                 dtype=torch.bfloat16),
        _la_case("dh64_kv_len", 3, 2, 130, 64, 17, gen, flush,
                 kv_len=torch.tensor([0, 64, 130], dtype=torch.int32, device=dev)),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "local_attention", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"local_attention disagrees with its plain version at {bad}")
    head = cases[0]
    return {
        "name": "local_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/local_attention.cu",
        "replaces": "src/repro/kernels/local_attention/local_attention.py:75",
        "launches": None, "ok": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
        "max_f64_ratio": max(c["f64_ratio"] for c in cases if c["dtype"] == "float32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_call": "F.scaled_dot_product_attention with the boolean window and key mask",
        "at": head["shape"], "ms_views": cases[1]["ms"], "shapes": cases,
    }


def _int8_case(name, M, K, N, gen, flush, timed=False):
    """x normal; w at fan-in scale in the C5 weight rep (per-output-channel
    scales), through `bench_kernels.int8_case`."""
    x = torch.randn((M, K), generator=gen, device="cuda")
    rep = quantize_weight(torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5)
    return {"shape": name, "M": M, "K": K, "N": N,
            **bench_kernels.int8_case(x, rep, flush=flush if timed else None)}


def _int8_matmul_kernel(gen, flush) -> dict:
    cases = [
        # the quantized ranker's widest linear (FFN w1) at a serve call of 512
        # requests; the model itself runs weight-only dequant, not W8A8
        _int8_case("ranker_w1_51200x64x256", 512 * 100, 64, 256, gen, flush, timed=True),
        _int8_case("bench_512", 512, 512, 512, gen, flush, timed=True),
        _int8_case("tower_512x208x200", 512, 208, 200, gen, flush),
        _int8_case("ragged_513x300x129", 513, 300, 129, gen, flush),
        _int8_case("one", 1, 1, 1, gen, flush),
        _int8_case("k_1001", 37, 1001, 65, gen, flush),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "int8_matmul", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"int8_matmul disagrees with its plain version at {bad}")
    head = cases[0]
    return {
        "name": "int8_matmul", "route": "cuda", "source": "src/repro_torch/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul/int8_matmul.py:41",
        "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_call": "torch._int_mm + the epilogue", "at": head["shape"],
        "at_512": {k: cases[1][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")},
        "shapes": cases,
    }


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = bench_kernels.l2_flush_buffer("cuda")
    kernels = {
        "embedding_bag": _embedding_bag_kernel(gen, flush),
        "fm_interaction": _fm_interaction_kernel(gen, flush),
        "augru": _augru_kernel(gen, flush),
        "block_pruned_matmul": _block_pruned_matmul_kernel(gen, flush),
        "local_attention": _local_attention_kernel(gen, flush),
        "int8_matmul": _int8_matmul_kernel(gen, flush),
    }
    del flush
    torch.cuda.empty_cache()
    return kernels


def phase_serve(arch, cfg, params_by_variant, batches):
    """Returns the kernel launches of this arch's run, by kernel, and each
    variant's median ms at each size."""
    serve.reset_launch_counts()
    results = {v: serve.calibrate_variant(p, serve.variant_cfg(v, cfg), batches, reps=SERVE_REPS)
               for v, p in params_by_variant.items()}
    launches = serve.launch_counts()
    for v, by_size in results.items():
        expect = EXPECT_LAUNCHES[(arch, v)]
        for n, r in by_size.items():
            p = r["probs"]
            # a trained variant may be sure enough that sigmoid rounds to 0 or 1 in f32
            finite_in_01 = bool(torch.isfinite(p).all() and ((p >= 0) & (p <= 1)).all())
            emit({"phase": "serve", "arch": arch, "variant": v, "size": n, "reps": SERVE_REPS,
                  "median_ms": float(np.median(r["ms"])),
                  "p90_ms": float(np.percentile(r["ms"], 90)),
                  "launches_per_call": r["launches_per_call"], "probs_ok": finite_in_01,
                  "saturated": int(((p == 0) | (p == 1)).sum())})
            if p.shape != (n,) or not finite_in_01:
                raise AssertionError(
                    f"{arch}/{v}@{n}: probabilities not finite in [0,1] of shape ({n},)")
            if r["launches_per_call"] != expect:
                raise AssertionError(
                    f"{arch}/{v}@{n}: kernel launches per call {r['launches_per_call']}, "
                    f"expected {expect}")
    for k in {k for v in params_by_variant for k, n in EXPECT_LAUNCHES[(arch, v)].items() if n}:
        if launches[k] == 0:
            raise AssertionError(f"the {arch} serve path launched no {k} kernel")
    emit({"phase": "serve_launches", "arch": arch, "launches": launches})
    return launches, {v: {n: float(np.median(r["ms"])) for n, r in by_size.items()}
                      for v, by_size in results.items()}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (inputs in us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def phase_profile(arch, variant, cfg, params, batches, serve_median_ms, sizes) -> None:
    """Where a serve call's time goes: the device's busy time and each
    kernel's share of it (torch.profiler). The profiler slows the host
    several-fold, so the idle share is taken against `serve_median_ms`, the
    unprofiled median of the serve phase at the same size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in sizes:
        batch = batches[n]
        for _ in range(3):
            api.serve(params, batch, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                api.serve(params, batch, cfg)
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_CALLS
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in kernels]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy_ms = _busy_ms(spans) / PROFILE_CALLS if spans else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit({"phase": "profile", "arch": arch, "variant": variant, "size": n,
              "calls": PROFILE_CALLS, "profiled_wall_ms_per_call": profiled_wall_ms,
              "serve_median_ms": serve_median_ms[n], "device_busy_ms_per_call": busy_ms,
              "device_idle_share": None if busy_ms is None else 1 - busy_ms / serve_median_ms[n],
              "device_ops_per_call": len(kernels) / PROFILE_CALLS,
              "kernel_ms_per_call": {
                  k: sum(v for name, v in by_name.items() if sym in name) / PROFILE_CALLS
                  for k, sym in KERNEL_SYMBOL.items()},
              "top_ms_per_call": [[k[:80], v / PROFILE_CALLS] for k, v in top]})


def phase_card_vs_cpu(arch, cfg, params_by_variant, batch) -> None:
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}
    for v, params in params_by_variant.items():
        vcfg = serve.variant_cfg(v, cfg)
        card = api.serve(params, batch, vcfg).to("cpu")
        host_params = _to_cpu(params)
        host = api.serve(host_params, cpu_batch, vcfg)
        del host_params
        diff = float((card - host).abs().max())
        emit({"phase": "card_vs_cpu", "arch": arch, "variant": v, "size": int(card.shape[0]),
              "max_abs_diff": diff, "tol": PROB_TOL})
        if not diff <= PROB_TOL:
            raise AssertionError(f"{arch}/{v}: card and CPU differ by {diff}")


def _to_cpu(tree):
    return tree_map(lambda t: t.to("cpu"), tree)


def phase_ladder():
    """taobao_ssa at full width: the launcher's pretraining, then the
    structured ladder. Returns the pretrained parameters and the five
    variants as a server runs them. The pretraining runs once more from the
    same start, after its launches are read, and must end in the same bits:
    every gradient on the card sums in a fixed order."""
    cfg = get_config("taobao_ssa")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = serve.make_params(cfg, dev, seed=0)
    start = tree_map(torch.clone, params)
    data = make_data(cfg, serve.TRAIN_BATCH, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    serve.reset_launch_counts()
    params, losses = serve.pretrain(params, cfg, data(0), serve.TRAIN_STEPS)
    torch.cuda.synchronize()
    t_pre = time.perf_counter()
    pre_launches = serve.launch_counts()
    again, _ = serve.pretrain(start, cfg, data(0), serve.TRAIN_STEPS)
    n_differ = sum(not torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_leaves(params), tree_leaves(again)))
    del start, again

    stage_losses, stage_end = {}, {}

    def on_step(stage, i, m):
        stage_losses.setdefault(stage, []).append(float(m["loss"]))  # float() waits for the step
        stage_end[stage] = time.perf_counter()

    serve.reset_launch_counts()
    t_ladder0 = time.perf_counter()
    ladder = run_ladder(params, cfg, lambda: data(1), LADDER, on_step=on_step)
    torch.cuda.synchronize()
    t_ladder = time.perf_counter()
    ladder_launches = serve.launch_counts()

    seconds, prev = {}, t_ladder0
    for stage in stage_end:  # in the order the stages ran
        seconds[stage] = stage_end[stage] - prev
        prev = stage_end[stage]
    seconds["serving_trees"] = t_ladder - prev
    fine = 3 * LADDER.finetune_steps + LADDER.qat_steps  # steps through the masked linears
    expect_ladder = {**_NONE, "embedding_bag": 5 * fine + 10 * LADDER.distill_steps,  # teacher
                     "block_pruned_matmul": 15 * fine}  # + student
    expect_pre = {**_NONE, "embedding_bag": 5 * serve.TRAIN_STEPS}
    stats = variant_stats(ladder)
    emit({"phase": "ladder", "arch": "taobao_ssa", "ladder": dataclasses.asdict(LADDER),
          "train_steps": serve.TRAIN_STEPS, "batch": serve.TRAIN_BATCH,
          "init_seconds": t_init - t0, "pretrain_seconds": t_pre - t_init,
          "pretrain_repeat_leaves_differing": n_differ,
          "ladder_seconds": t_ladder - t_ladder0, "stage_seconds": seconds,
          "pretrain_losses": losses, "stage_losses": stage_losses,
          "launches_pretrain": pre_launches, "launches_ladder": ladder_launches,
          "variant_stats": stats,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    all_losses = losses + [x for v in stage_losses.values() for x in v]
    if not all(np.isfinite(all_losses)):
        raise AssertionError("a training loss is not finite")
    if n_differ:
        raise AssertionError(f"pretraining again from the same start: {n_differ} leaves differ")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"pretraining loss did not fall: {losses[:5]} ... {losses[-5:]}")
    if pre_launches != expect_pre or ladder_launches != expect_ladder:
        raise AssertionError(f"training launches {pre_launches}, {ladder_launches}; "
                             f"expected {expect_pre}, {expect_ladder}")
    if not 0.2 < stats["pruned"]["sparsity"] < 0.5:
        raise AssertionError(f"structured sparsity {stats['pruned']['sparsity']}")
    variants = {name: serving_params(name, v["params"], LADDER) for name, v in ladder.items()}
    launches = {k: pre_launches[k] + ladder_launches[k] for k in pre_launches}
    return params, variants, launches


def _compare_step(label, before, card, host, grads):
    """Every updated float leaf of the card's step against the CPU's.
    `grads` None: an SGD step at lr 1, whose update is the clipped gradient;
    else the CPU's clipped gradients, for an AdamW step."""
    worst, rows = 0.0, []
    for (path, c), (_, h), (_, b) in zip(tree_leaves(card), tree_leaves(host),
                                         tree_leaves(before)):
        if not c.is_floating_point():
            if not torch.equal(c.cpu(), h):
                raise AssertionError(f"{label}: integer leaf {path} changed")
            continue
        d = (c.cpu() - h).abs()
        row = {"leaf": "/".join(path), "max_abs_diff": float(d.max()),
               "n_above_1e-6": int((d > 1e-6).sum()), "n": d.numel()}
        u = (h - b).abs()
        row["norm_rel"] = float(d.norm() / u.norm().clamp(min=1e-30))
        if grads is None:
            row["max_rel"] = float(d.max() / u.max().clamp(min=1e-30))
            row["ok"] = (float(d.max()) <= TRAIN_SGD_MAX_REL * float(u.max()) + 1e-7
                         and float(d.norm()) <= TRAIN_SGD_NORM_REL * float(u.norm()) + 1e-7)
        else:
            g = grads[path].abs()
            off = (d > TRAIN_ADAM_ATOL) & (g > TRAIN_ADAM_SMALL_GRAD * g.max())
            row["n_off_rule"], row["n_moved"] = int(off.sum()), int((u > 0).sum())
            row["ok"] = (row["n_off_rule"] <= TRAIN_ADAM_SHARE * row["n_moved"]
                         and float(d.norm()) <= TRAIN_ADAM_NORM_REL * float(u.norm()))
        rows.append(row)
        worst = max(worst, float(d.max()))
    return worst, rows


def phase_train_vs_cpu(params) -> None:
    """One train step from the same parameters and batch on the card and on
    the CPU: the dense tree and a structured-masked one, AdamW and SGD."""
    cfg = get_config("taobao_ssa")
    host_batch = next(make_data(cfg, serve.TRAIN_BATCH, "cpu")(3))
    card_batch = {k: v.to("cuda") for k, v in host_batch.items()}
    masked = pruning.with_block_masks(pruning.prune_tree(
        params, pruning.prune_schedule(LADDER.prune_target, LADDER.prune_rounds)[0],
        structured=True))
    for tree_name, tree in (("dense", params), ("structured", masked)):
        host_tree = _to_cpu(tree)
        grads = None  # the SGD step runs first and gives the CPU's clipped gradients
        for opt_name, opt in (("sgd", sgd(1.0, momentum=0.0)), ("adamw", adamw(LADDER.lr))):
            step = make_train_step(lambda p, b: api.loss(p, b, cfg), opt)
            serve.reset_launch_counts()
            t0 = time.perf_counter()
            card, _, card_m = step(tree, opt.init(tree), card_batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = serve.launch_counts()
            host, _, host_m = step(host_tree, opt.init(host_tree), host_batch)
            t2 = time.perf_counter()
            worst, rows = _compare_step(f"{tree_name}/{opt_name}", host_tree, card, host, grads)
            if opt_name == "sgd":
                grads = {path: b - a for (path, b), (_, a) in
                         zip(tree_leaves(host_tree), tree_leaves(host)) if b.is_floating_point()}
            loss_c, loss_h = float(card_m["loss"]), float(host_m["loss"])
            gn_c, gn_h = float(card_m["grad_norm"]), float(host_m["grad_norm"])
            bad = [r["leaf"] for r in rows if not r["ok"]]
            emit({"phase": "train_vs_cpu", "tree": tree_name, "optimizer": opt_name,
                  "loss_card": loss_c, "loss_cpu": loss_h, "grad_norm_card": gn_c,
                  "grad_norm_cpu": gn_h, "max_abs_diff": worst, "card_seconds": t1 - t0,
                  "cpu_seconds": t2 - t1, "launches": launches, "bad_leaves": bad,
                  "leaves": rows})
            expect_bpm = 15 if tree_name == "structured" else 0
            if launches["embedding_bag"] != 5 or launches["block_pruned_matmul"] != expect_bpm:
                raise AssertionError(f"train step launches {launches}")
            if bad or abs(loss_c - loss_h) > LOSS_REL * abs(loss_h) or \
                    abs(gn_c - gn_h) > GRAD_NORM_REL * gn_h:
                raise AssertionError(f"{tree_name}/{opt_name}: card and CPU steps differ: "
                                     f"{bad}, loss {loss_c} vs {loss_h}, gnorm {gn_c} vs {gn_h}")
            del card, host
        del host_tree, grads
    torch.cuda.empty_cache()


def drive_arch(arch: str, variants=None) -> dict:
    """Serve, profile and card-vs-CPU for one arch at full width; returns
    the kernel launches of its serve phase. `variants` are the trees to
    serve (taobao_ssa: the ladder's); by default the arch's own from random
    weights."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device("cuda")
    if variants is None:
        params = serve.make_params(cfg, dev, seed=0)
        variants = serve.build_variants(params, serve.variants_for(cfg), cfg)
        del params
    batches = serve.request_batches(cfg, SIZES, dev)
    setup_s = time.perf_counter() - t0
    launches, serve_median_ms = phase_serve(arch, cfg, variants, batches)
    for v, vparams in variants.items():
        sizes = (1, max(SIZES)) if v == "baseline" and arch == "taobao_ssa" else (max(SIZES),)
        phase_profile(arch, v, serve.variant_cfg(v, cfg), vparams, batches, serve_median_ms[v],
                      sizes)
    phase_card_vs_cpu(arch, cfg, variants, batches[max(SIZES)])
    emit({"phase": "arch_done", "arch": arch, "setup_seconds": setup_s,
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del variants, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches


def phase_serve_c2() -> dict:
    """taobao_ssa under the paper's C2 window (`C2_WINDOW`) through the
    launcher's own entry point, `serve.run`, at full width: it pretrains
    (every step's two attentions through the local-attention kernel), runs
    the structured ladder and serves the five variants at every size. The
    launches are counted from 0 over the whole call and must equal
    training's plus serving's, each worked out from the steps and calls.
    Then, from the launcher's own pretrained parameters (pretraining
    repeats bit for bit): the card against the CPU on `baseline` and
    `quantized`, a window of L = 100 against the unwindowed model, and a
    profile of `baseline` at 1 and 512. Returns the launches."""
    t0 = time.perf_counter()
    base_cfg = get_config("taobao_ssa")
    cfg = with_attn_window(base_cfg, C2_WINDOW)
    dev = torch.device("cuda")
    serve.reset_launch_counts()
    records = serve.run(cfg, sizes=SIZES, device=dev, reps=SERVE_REPS, ladder=LADDER)
    torch.cuda.synchronize()
    launches = serve.launch_counts()
    run_s = time.perf_counter() - t0
    *timed, stats = records
    medians = {}
    for r in timed:
        v, n = r["variant"], r["size"]
        medians.setdefault(v, {})[n] = r["median_ms"]
        emit({"phase": "serve", "arch": "taobao_ssa_c2", "attn_window": C2_WINDOW, **r})
        if r["launches_per_call"] != EXPECT_LAUNCHES[("taobao_ssa_c2", v)]:
            raise AssertionError(f"taobao_ssa_c2/{v}@{n}: kernel launches per call "
                                 f"{r['launches_per_call']}, expected "
                                 f"{EXPECT_LAUNCHES[('taobao_ssa_c2', v)]}")
    calls = (serve.WARMUP + SERVE_REPS) * len(SIZES)  # serve calls of each variant
    serving = {k: calls * sum(EXPECT_LAUNCHES[("taobao_ssa_c2", v)][k] for v in medians)
               for k in _NONE}
    fine = 3 * LADDER.finetune_steps + LADDER.qat_steps  # steps through the masked linears
    training = {**_NONE,
                # distillation collects attention probabilities: the plain softmax
                "local_attention": 2 * (serve.TRAIN_STEPS + fine),
                "embedding_bag": 5 * (serve.TRAIN_STEPS + fine) + 10 * LADDER.distill_steps,
                "block_pruned_matmul": 15 * fine}
    expect = {k: training[k] + serving[k] for k in _NONE}
    emit({"phase": "serve_c2_launches", "attn_window": C2_WINDOW, "launches": launches,
          "expected_training": training, "expected_serving": serving, "seconds": run_s,
          "variant_stats": stats["variant_stats"]})
    if launches != expect:
        raise AssertionError(f"C2 path launches {launches}, expected {expect}")

    params, _ = serve.base_params(cfg, dev)
    batches = serve.request_batches(cfg, SIZES, dev)
    variants = serve.build_variants(params, ("baseline", "quantized"), cfg)
    phase_card_vs_cpu("taobao_ssa_c2", cfg, variants, batches[max(SIZES)])
    wide = with_attn_window(base_cfg, base_cfg.seq_len)
    for v, vparams in variants.items():
        full = api.serve(vparams, batches[max(SIZES)], base_cfg)
        windowed = api.serve(vparams, batches[max(SIZES)], wide)
        diff = float((full - windowed).abs().max())
        emit({"phase": "window_L_vs_full", "variant": v, "attn_window": wide.attn_window,
              "max_abs_diff": diff, "tol": PROB_TOL})
        if not diff <= PROB_TOL:
            raise AssertionError(f"{v}: a window of L and full attention differ by {diff}")
    phase_profile("taobao_ssa_c2", "baseline", cfg, variants["baseline"], batches,
                  medians["baseline"], (1, max(SIZES)))
    emit({"phase": "arch_done", "arch": "taobao_ssa_c2", "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, variants, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches


def phase_bench() -> dict:
    """`python -m repro_torch.launch.bench_kernels`'s rows: all six kernels
    at `benchmarks/bench_kernels.py`'s shapes. Returns the launches."""
    t0 = time.perf_counter()
    serve.reset_launch_counts()
    rows = bench_kernels.run("cuda", seed=0)
    launches = serve.launch_counts()
    for r in rows:
        emit({"phase": "bench_kernels", **r})
    emit({"phase": "bench_kernels_launches", "launches": launches,
          "seconds": time.perf_counter() - t0})
    bad = [r["kernel"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"bench_kernels: {bad} disagree with their plain versions")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"bench_kernels launched no {missing} kernel")
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernels = phase_kernels()
    params, ladder_variants, train_launches = phase_ladder()
    phase_train_vs_cpu(params)
    del params

    # launches by main path: taobao_ssa's training (pretraining and the
    # ladder), then each arch's serve phase; each counted from 0
    by_path = {"train_taobao_ssa": train_launches}
    for arch in PORTED:
        by_path[f"serve_{arch}"] = drive_arch(arch, ladder_variants if arch == "taobao_ssa" else None)
        ladder_variants = None
    by_path["serve_taobao_ssa_c2"] = phase_serve_c2()
    by_path["bench_kernels"] = phase_bench()
    for name, rec in kernels.items():
        rec["launches_by_path"] = {path: n[name] for path, n in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["launches"] == 0:
            raise AssertionError(f"no main path launched the {name} kernel")

    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{k: v for k, v in rec.items() if k not in ("shapes", "checks")}
                      for rec in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
