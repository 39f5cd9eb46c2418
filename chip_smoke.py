#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --size-cells   # phase 19's cuts (see below)

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
   PyTorch library call: embedding_bag at taobao_ssa's, FM's, DIEN's (and
   DIN's) and AutoInt's lookups, fm_interaction at FM's B=512 and the benchmark's 65,536
   (timed), ragged B, k of 1 to 33, e off a 16-byte boundary and examples
   too wide for shared memory (each launched twice for the same bits),
   augru at DIEN's B=512, a ragged
   B, one row and the benchmark's 4096 (launched twice for the same bits),
   block_pruned_matmul at every masked linear of a structured
   taobao_ssa serve call of 512 requests and at densities 0 and 1 (also
   against an f64 product, and launched twice for the same bits),
   local_attention at the C2 ranker's call of 512 requests (BH 2048,
   L 100, dh 16, window 32, the history key mask), on contiguous tensors
   and on the encoder's views of [B, L, H, dh] projections, and at ragged,
   causal, bf16, dh 32/64/128 and no-valid-key cases (each launched twice,
   and on contiguous copies, for the same bits), int8_matmul at the ranker's
   FFN w1 (51,200 x 64 x 256), at 512³ and the tower's 512 x 208 x 200
   (timed) and at ragged shapes (int32 accumulators equal to the plain
   version's, two launches the same bits), each with its launch plan.
   Beside every bound stands the launch floor, the time of a one-element
   `fill_` under the same timing.
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
Then, for each ported arch in turn (taobao_ssa, fm, dien, din, autoint),
at full width, its parameters freed before the next (taobao_ssa: the
ladder's five trained variants; the others: random weights from seed 0):
6. serve   — the arch's variants (taobao_ssa: all five; fm and din:
   `baseline` and `quantized`; dien and autoint: `baseline`) at
   1/8/32/128/512 requests through
   `repro_torch.launch.serve`; every kernel's launch count is reset just
   before and read just after, and must match `EXPECT_LAUNCHES`.
7. profile — serve calls' device busy time and each kernel's share
   (torch.profiler), every variant at 512 and baseline at 1; the idle
   share sets that busy time against the serve phase's unprofiled median,
   since the profiler slows the host.
8. calibrate — each variant's latency curve, `serve.latency_model` at
   1/8/32/128/512 (a warm call and 20 timed ones a size, the card
   synchronised after each call); launches counted from 0 and exact.
9. card vs CPU — the same parameters and one 512-request batch through
   `serve` on the card and on the CPU's plain path, every variant.
10. simulate — each curve behind the launcher's `ElasticEngine`
   (`serve.run_engine`: two autoscaled replicas, p99 SLO 100 ms) for 60
   simulated seconds under `SIM_PROFILES[arch]`: the curve, lat(1),
   lat(512), `sustainable_rate` at the engine's 5 ms batching window, the
   full-batch rate 2·64 / lat(64) (two replicas closing batches of the
   engine's `max_batch`), and per profile p50, p99, throughput, rejected,
   arrived, completed and in_queue; then each variant's p99 and rates
   over baseline's (a record, not a check). It raises on a curve point not finite and > 0, a 512
   point below the variant's device busy time a call at 512 (phase 7),
   arrived ≠ completed + rejected + in_queue, or a `REPEAT_PROFILE` run
   repeated in other numbers.
Then two more paths, each with its launches counted from 0:
11. serve_taobao_ssa_c2 — taobao_ssa under the paper's C2 window of 32
   through `serve.run(..., profile="spike")`: pretraining, the structured
   ladder, the five variants at every size, each variant's curve and its
   engine run; launches per call and in all (training's, serving's and
   calibration's, worked out); then card vs CPU on baseline and
   quantized, a window of L = 100 against full attention, a profile at 1
   and 512, and the simulate phase on the launcher's curves (its spike
   runs equal to `serve.run`'s own).
12. bench_kernels — `python -m repro_torch.launch.bench_kernels`'s six
   rows, every kernel at `benchmarks/bench_kernels.py`'s shapes.
13. train — `launch/train.run`, the training launcher, for taobao_ssa,
   fm, dien, din and autoint at its config (vocabularies cut to 5,000, widths as
   configured), AdamW on batches of 256, each run in a fresh directory: 30
   steps checkpointed every 10 that crash at step 25, the run that resumes
   from step 20 (one restart), and an uninterrupted 30-step run, which the
   resumed one must equal to the bit (parameters and optimizer state);
   finite losses; launches exact (each step: the arch's serve-call lookups,
   and one fm_interaction or augru, forward only: their backwards are plain
   PyTorch); the uninterrupted run's checkpoint restored on the CPU to the
   bit; a step's time with and without its backward; one SGD and one
   AdamW step of FM, DIEN, DIN and AutoInt on the card against the CPU
   under phase 5's rule; then 10 adam8bit steps of taobao_ssa, finite, and their
   checkpoint (int8 moments) restored on the card and on the CPU to the bit.
14. compress_and_serve — `launch/compress_and_serve.run(steps=60)`, the
   pipeline end to end, checkpointing into the fresh temporary directory
   it makes without `ckpt_dir` (which must be gone afterwards): training,
   the unstructured ladder at 20/20/40, each variant's curve under the
   45 s spike, the cached lookup of the trained item table (it raises
   unless it equals the uncached one bit for bit), and the cache-serving
   rows; stage seconds, launches exact.
15. quickstart — `launch/quickstart` at the example's defaults (taobao_ssa
   at vocabularies of 10,000, 100 AdamW steps at batch 512, the
   unstructured ladder at 15/15/30): finite losses, the five variants'
   table (params, bytes, HR@10, NDCG@50, MRR, each finite in [0, 1]; a
   record, no threshold), launches exact, and each variant's 256 × 50
   evaluation scores on the card against the same parameters through the
   CPU's plain path within `PROB_TOL`.
16. lm_serve — the LM family, which launches none of the six kernels
   (counted from 0, each must stay 0): `yi_6b` and `olmoe_1b_7b` as
   configured, full width and depth, bf16, weights from seed 0 on the
   card; the parameter count of `param_defs` beside the config's; a
   prefill of 4 × 2,048 tokens (`lm_token_batches`, seed 0; KV chunks of
   1,024), the caches placed in 2,112 positions, 64 greedy decode steps;
   prefill ms, decode ms a step (median of 64), tokens a second and
   `max_memory_allocated`, each beside its bound (`_lm_flops_bytes` at the
   spec sheet's bf16 rate and HBM rate). yi_6b: the decode of token 1,023
   at position 1,023 from a 1,023-token prefill against the last position
   of a 1,024-token prefill, and the C2 decode at the config's window
   (every global sample a duplicate) against that dense decode, both
   within `LM_DECODE_TOL`; then 64 C2 steps under `LM_C2_OVERRIDES`,
   timed. olmoe_1b_7b: the entries each capacity stage of the prefill's
   one-group dispatch dropped, and the experts each decode step chose.
   Then each at full width with 2 layers in f32 on the card against the
   CPU (2 × 128 tokens: prefill logits, 4 decode steps, the loss) within
   `LM_CARD_CPU_TOL`.
17. gnn_full_size — NequIP as configured (5 layers, 32 channels, l_max
   2, f32; weights from seed 0) at the dry run's GNN shapes one card
   holds (`gnn_batch`): molecule (128 molecules, 3,840 atoms, 8,192
   edges, `energy_loss`), full_graph_sm (Cora-sized: 2,708 nodes, 10,556
   edges, 1,433 features, 7 classes) and minibatch_lg (1,024 seeds of a
   Reddit-sized graph sampled at fanout (15, 10): 169,984 nodes, 168,960
   edges, 602 features, 41 classes, the seeds' labels). Each: the forward
   on the card against the CPU's within `GNN_CARD_CPU_TOL` of the largest
   output (molecule, full_graph_sm), a rotation of the positions within
   `GNN_ROT_TOL`, 8 AdamW steps on the batch whose loss must fall, run
   twice from the same start to the same bits, launches exact (one
   `embedding_bag` a step for molecule's species lookup, none for the
   feature shapes), then a step's and the loss's median ms beside their
   bounds (`gnn_flops_bytes`: f32 at the spec sheet's CUDA-core rate, TF32
   being off, and HBM rate), `max_memory_allocated`, a profiled step (the
   device's busy ms and idle share, its six costliest kernels), and the
   forward's 75
   node-feature gathers with their backward two ways (`nequip.gather`,
   the port's, against `embedding_bag_op` at one id a bag; the same
   gradient bits). ogb_products is reckoned, not run: one layer's f32
   messages (39.6 GB) and `_p222`'s matrices (71.3 GB each) exceed a card.
Phase 13 also trains `yi_6b` and `olmoe_1b_7b` through the launcher
(its LM config: 2 layers, d 128, vocab 512, bf16; crash, resume and
uninterrupted runs the same bits; a step on the card against the CPU's in
f32 under phase 5's rule), and each at full width cut to 2 layers (0.87 B
and 1.05 B parameters, bf16, AdamW) for 8 steps on one batch of 4 × 128
tokens, timed: the loss must fall; and `nequip` as configured, on the
launcher's `random_graph`s of 512 nodes (crash, resume and uninterrupted
runs the same bits; one `embedding_bag` launch a step, the species
lookup; SGD and AdamW steps on the card against the CPU's under phase 5's
rule).
18. distributed — the distributed layer on one card through a real NCCL
   communicator at world size 1 (a FileStore, the (1, 1) test mesh; no
   fallback to gloo): olmoe_1b_7b's MoE layer at full width (bf16, 64
   experts top-8, d_ff 1,024) on 4 × 2,048 tokens and llama4's (128
   experts top-1, d_ff 8,192, one shared expert; 32.2 GB of expert
   weights, forward only) on 1 × 4,096, each through the mesh (every
   all_to_all, all_gather and all_reduce run) and through the
   one-group path: the same bits (out, aux, drop counts and, for olmoe,
   every gradient; deterministic algorithms on), then each path's median
   forward (and forward+backward) ms and peak GB; olmoe's f32 weight
   gradients through `compress_allreduce_mean` (mean and residual the
   CPU's bits; 50 error-feedback steps within `repro`'s bound; ms a step,
   bytes handed to the all-reduce); the olmoe layer saved and restored
   under its `param_pspecs`, every leaf a DTensor of the saved bits.
19. recsys_cells — the five recsys archs' dry-run cells
   (`launch/cells.build_cell`) at full width, weights from a seed, through
   a one-rank NCCL mesh (the (1, 1) test mesh): serve_p99 (512),
   serve_bulk (262,144), retrieval_cand (1,000,000 candidates, padded to
   1,000,448) and one AdamW step of train_batch (65,536); a cell whose
   peaks pass `REC_PEAK_BUDGET` or `REC_RESERVED_BUDGET` at that size runs
   at `REC_CUTS`'s, the largest multiple of 512 that fits (`python3 chip_smoke.py --size-cells`
   finds them on the card: probes of each cell's peak, from the whole size
   down). At one rank every exchange is over a mesh dim of one rank, which
   the lookup, the loss's mean and the step skip, so a cell's `fn` runs
   the plain path and the NCCL group carries no collective. Each cell's
   `fn` against the plain call (no rules) on the same inputs, once: the
   same bits (every output leaf), the launches of one call, the peak GB of
   the two; then the median ms of `fn` (`SERVE_REPS` calls at serve_p99,
   `REC_REPS` past it). Before those cells, ranks that split the tables
   on the one card: 2 and then 4 processes (spawned; gloo groups, every tensor on cuda:0,
   each exchange copied through host memory), as (1, 2), (2, 2) and
   (1, 4) meshes, run taobao_ssa's and FM's serve_p99, retrieval_cand and
   one AdamW step at `RANK_STEP_BATCH`, and taobao_ssa's serve_p99 under
   the C2 window and with a structured-pruned tower, each rank on its
   blocks (the kernel's row range sees the other ranks' ids; the C2 and
   pruned calls launch `local_attention` and `block_pruned_matmul`):
   every forward block the one-rank call's bits on the whole tables and
   the rank's blocks of the rest, the step within phase 5's rule against
   the one-rank step's block.
20. lm_ranks — the LM trunk across ranks, which launches none of the six
   kernels: yi_6b and olmoe_1b_7b at full width cut to 2 layers, bf16,
   weights from seed 20 (olmoe's capacity factor 4: no entry drops on any
   mesh). The one-rank calls first, saved to the host: the cross
   entropy's gradients and an AdamW step of 4 × 1,024 tokens, a prefill of
   4 × 2,048, 8 decode steps of 4 rows from a 4,096-position prefill, and
   4 batch-1 C2 decode steps from a 16,384-position prefill (olmoe's two
   decodes also with its weights in f32). Then 2 and 4 processes sharing
   the card over gloo (every exchange through host memory) as (1, 2),
   (2, 2) and (1, 4) meshes run `launch/cells`' LM cells on their blocks
   (the decode's cache split over "model", the long-context one over
   ("data", "model")); each rank's ms, peak GB and largest difference from
   the one-rank call's block, held at `LM_RANK_*_TOL` (an MoE arch's bf16
   decode is recorded, its f32 decode held: see `LM_RANK_F32_TOL`).
21. dryrun — run right after the build, while the card holds nothing
   else: `launch/dryrun`, which launches no kernel. (a) fm serve_p99 and
   yi_6b decode_32k on the 16x16 mesh (fake process groups of 256 ranks,
   one process each) on fake cuda tensors give the record of fake cpu
   tensors, all but `device` and `timings`; (b) DIEN's AdamW step at
   `REC_CUTS`' 51,200 examples run for real (in a process of its own, so
   that its ~79 GB peak pins no cached segment of this process) through a
   one-rank NCCL mesh under the dry run's counter (`launch/hlo_stats.count`) gives the dry
   run's dot flops, kernel calls and work and collectives on a fake (1, 1)
   mesh, and launches as many kernels as the dry run counts calls (these
   launches stay out of the `kernels` line); (c) that call's
   `max_memory_allocated` over the dry run's `peak_bytes`, printed beside
   the card's name and power limit, within `DRYRUN_MEM_RATIO`.
The kernels phase also runs `embedding_bag`'s row range (51,200 ids into
one block of the item table split 2 and 4 ways).

Then the `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Any failure raises and the exit code is
not 0; nothing is caught and passed over.
"""
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import RECSYS_ARCHS, get_config, with_attn_window  # noqa: E402
from repro_torch.configs.shapes import GNN_SHAPES, RECSYS_SHAPES  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core.compression_loop import run_ladder, serving_params, variant_stats  # noqa: E402
from repro_torch.core.quantization import quantize_weight  # noqa: E402
from repro_torch.core.serving.engine import EngineConfig  # noqa: E402
from repro_torch.core.serving.replica import ReplicaSpec, sustainable_rate  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.augru import augru as augru_kernel  # noqa: E402
from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import block_pruned_matmul as bpm_kernel  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    bench_kernels, cells, compress_and_serve, hlo_stats, quickstart, serve, train,
)
from repro_torch.launch.bench_kernels import bound, time_ms  # noqa: E402
from repro_torch.launch.train import make_data  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.distributed import expert_parallel, grad_compression  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    LM_RULES, P, adapt_rules, block_slices,
)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.gnn import nequip, sampler  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    init_params, param_count, param_pspecs, tree_leaves, tree_map,
)
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.training.optimizer import adamw, sgd  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402

SIZES = (1, 8, 32, 128, 512)
SERVE_REPS = 20
PROFILE_CALLS = 10
PROB_TOL = 1e-5  # card vs CPU, on probabilities
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
# CPU's step moved excepted. A leaf whose gradient is zero by the model's
# algebra (DIN's attention-MLP output bias `attn_bout` shifts every logit
# of a softmax, which ignores the shift) carries on each device only the
# f32 residue of a sum that cancels (~1e-12), which AdamW turns into an
# update of either sign, so no rule on ‖Δ‖ / ‖u‖ can hold there: a leaf
# whose clipped gradient on both devices lies below 1e-6 of the tree's
# largest is held instead to that floor on both (a gradient the card got
# wrong would stand above it) and to AdamW's bound |Δ| ≤ 2·lr.
TRAIN_SGD_MAX_REL, TRAIN_SGD_NORM_REL = 0.1, 1e-2
TRAIN_ADAM_NORM_REL = 0.2
TRAIN_ADAM_ATOL, TRAIN_ADAM_SMALL_GRAD, TRAIN_ADAM_SHARE = 1e-6, 1e-3, 1e-2
TRAIN_ZERO_GRAD_REL = 1e-6
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
    # DIN: user, item, category and the two histories; its int8 tables are
    # gathered plainly. AutoInt: one unified-table lookup of 39 ids a row
    ("din", "baseline"): {**_NONE, "embedding_bag": 5},
    ("din", "quantized"): dict(_NONE),
    ("autoint", "baseline"): {**_NONE, "embedding_bag": 1},
}
C2_WINDOW = 32  # the C2 path's window: a third of L = 100
# traffic profiles each path's curves are served under (simulate phase),
# and the one every variant runs twice, which must give the same numbers
SIM_PROFILES = {"taobao_ssa": ("steady", "spike", "ramp"),
                "taobao_ssa_c2": ("steady", "spike", "ramp"), "fm": ("spike",), "dien": ("spike",),
                "din": ("spike",), "autoint": ("spike",)}
REPEAT_PROFILE = "spike"
COUNTS = ("arrived", "completed", "in_queue")  # of an engine run, beside `serve.serving_record`
# the training launcher's phase: steps, checkpoint interval, injected crash
# (after the checkpoint of step 20), batch, and the steps of each timing
TRAIN_ARCHS = ("taobao_ssa", "fm", "dien", "din", "autoint", "yi_6b", "olmoe_1b_7b", "nequip")
# kernel launches of a train step's forward where it is not the serve
# call's: NequIP's species lookup (its gathers and scatters are PyTorch's
# index_select and fixed-order segment_reduce)
STEP_LAUNCHES = {"nequip": {**_NONE, "embedding_bag": 1}}
FT_STEPS, FT_CKPT_EVERY, FT_CRASH_AT, FT_BATCH, STEP_TIMING_REPS = 30, 10, 25, 256, 5
ADAM8BIT_STEPS = 10
E2E_STEPS = 60  # compress_and_serve's training steps (the example's 300, cut)
# the LM phases: phase 16 `lm_serve` and phase 13's LM runs. yi_6b and
# olmoe_1b_7b are the LM configs whose bf16 weights (12.1 and 13.8 GB) one
# 80 GB card holds with room for their caches and activations
LM_SERVE_ARCHS = ("yi_6b", "olmoe_1b_7b")
LM_BATCH, LM_PREFILL, LM_DECODE_STEPS, LM_PREFILL_REPS = 4, 2048, 64, 3
LM_CACHE = LM_PREFILL + LM_DECODE_STEPS  # 2,112 positions
LM_CHECK_S = 1024  # decode against prefill: one KV chunk, dense attention
LM_C2_OVERRIDES = {"attn_window": 512, "attn_n_global": 128}
# decode against prefill, relative to the largest |logit|, bf16: decode's
# scores are a bf16 product (`repro`'s einsum has no f32 output type there)
# where prefill's are f32, and the difference passes 32 layers; set before
# the first card run from 1.8e-2 in a CPU run at 32 layers of width 512
LM_DECODE_TOL = 5e-2
# card against CPU: full width, 2 layers, f32 with TF32 off, 2 x 128 tokens
LM_CPU_LAYERS, LM_CPU_TOKENS, LM_CPU_DECODE, LM_CARD_CPU_TOL = 2, (2, 128), 4, 1e-5
# the full-width training step: 2 layers, bf16, AdamW, one batch of 4 x
# 128 tokens, 8 steps. `repro`'s arch smoke test's lr of 3e-3 moves every
# weight of width 4,096 (std 0.016) by a fifth in AdamW's first step: yi's
# loss went 11.87, 3.37, 7.89, 9.39, ... 9.82 on the card; 1e-4 overfits
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_STEPS, LM_TRAIN_LR = 2, 4, 8, 1e-4
# phase 17: NequIP as configured at the dry run's GNN shapes one card
# holds, with `repro`'s cell's class counts (`launch/cells._GNN_CLASSES`);
# 8 AdamW steps on one batch at the launcher's lr. ogb_products is reckoned,
# not run (`_ogb_products_reckoning`)
GNN_RUN_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_CLASSES = {"molecule": 1, "full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47}
GNN_STEPS, GNN_LR = 8, 1e-3
# card against CPU, f32 with TF32 off, relative to the largest |output|:
# f32 sums in another order through 5 layers
GNN_CARD_CPU_TOL = 1e-5
# a rotation of the positions against none, relative to the largest
# |output|: invariant in exact arithmetic; set before the first card run
# from CPU runs as configured, 3.3e-7 (molecule) and 1.9e-7 (full_graph_sm),
# with room for the card's other rounding
GNN_ROT_TOL = 1e-4
# the spec sheet's dense bf16 rate, f32 rate outside the tensor cores and
# HBM rate of an H100 SXM at 700 W
H100_BF16_FLOPS, H100_F32_FLOPS, H100_HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
# phase 18: the distributed layer through NCCL at world size 1. Each MoE
# layer at full width, bf16, one layer's weights from seed 0: olmoe_1b_7b's
# forward and backward on 4 x 2,048 tokens, llama4's forward on 1 x 4,096
# (32.2 GB of expert weights; over the one-rank dp group the FSDP gather
# is skipped, so neither path holds a second copy). `repro`'s error-feedback test: 50 steps
# average to the gradient within rtol = atol = 2e-2, here on the scale of
# each leaf's largest |g| (the leaves' gradients are far below 1)
DIST_MOE = {"olmoe_1b_7b": (4, 2048, True), "llama4_maverick_400b_a17b": (1, 4096, False)}
COMPRESS_STEPS, COMPRESS_TOL = 50, 2e-2
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
                  flush),  # DIN's history lookup too: the same fields
        _bag_case("autoint_unified_nnz1", fm_rows, 16, fm_vocab, 512 * 39, 1, False, gen, flush),
    ]
    # the row range: taobao_ssa's history lookup into one block of the item
    # table split 2 and 4 ways (half and three quarters of the ids foreign)
    item = torch.randn((200_192, 64), generator=gen, device="cuda")
    hist = torch.randint(0, 200_000, (512 * 100, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    ranges = [{"shape": f"taobao_item_hist_nnz1_block_of_{ways}", "table": [200_192, 64],
               "B": 512 * 100, "nnz": 1, **bench_kernels.embedding_bag_range_case(
                   item, hist, ways, 0, flush=flush)} for ways in (2, 4)]
    del item, hist
    torch.cuda.empty_cache()
    for c in cases + ranges:
        emit({"phase": "kernels", "kernel": "embedding_bag", **c})
    bad = [c["shape"] for c in cases + ranges if not c["ok"]]
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
        "vs_library": head["vs_library"], "at": head["shape"], "shapes": cases + ranges,
    }


def _fm_case(name, B, F_, k, gen, flush, timed=False, offset=0):
    """One shape through `bench_kernels.fm_interaction_case`; `offset`
    floats into a larger allocation, so that e starts off a 16-byte
    boundary (the kernel's unaligned head and ragged tail)."""
    base = torch.randn((offset + B * F_ * k,), generator=gen, device="cuda")
    e = base[offset:].view(B, F_, k)
    return {"shape": name, "B": B, "F": F_, "k": k, "offset": offset,
            **bench_kernels.fm_interaction_case(e, flush=flush if timed else None)}


def _fm_interaction_kernel(gen, flush) -> dict:
    F_, k = 39, 10  # Criteo's FM
    cases = [
        _fm_case("fm_serve_512", 512, F_, k, gen, flush, timed=True),
        _fm_case("bench_65536", 65_536, F_, k, gen, flush, timed=True),
        _fm_case("ragged_511", 511, F_, k, gen, flush),
        _fm_case("ragged_37", 37, F_, k, gen, flush),
        _fm_case("one", 1, F_, k, gen, flush),
        *(_fm_case(f"k{kk}_37", 37, F_, kk, gen, flush) for kk in (1, 3, 16, 33)),
        _fm_case("offset_1_float", 37, F_, k, gen, flush, offset=1),
        _fm_case("wide_40x2000", 3, 40, 2000, gen, flush),  # an example of 320 KB
        _fm_case("wide_60000x1", 3, 60_000, 1, gen, flush),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "fm_interaction", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fm_interaction disagrees with its plain version or repeats in "
                             f"other bits at {bad}")
    head, big = cases[0], cases[1]  # FM's serve call; the kernel benchmark's batch
    return {"name": "fm_interaction", "route": "cuda",
            "source": "src/repro_torch/csrc/fm_interaction.cu",
            "replaces": "src/repro/kernels/fm_interaction/fm_interaction.py:25",
            "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "library_none": "no single PyTorch call computes the FM sum-square interaction",
            "at": head["shape"], "plan": head["plan"],
            "at_65536": {key: big[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "plan")},
            "shapes": cases}


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
        _int8_case("tower_512x208x200", 512, 208, 200, gen, flush, timed=True),
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
        "library_call": "torch._int_mm + the epilogue", "at": head["shape"], "plan": head["plan"],
        **{f"at_{c['shape']}": {k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by", "plan")} for c in cases[1:3]},
        "shapes": cases,
    }


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = bench_kernels.l2_flush_buffer("cuda")
    floor = bench_kernels.launch_floor_ms("cuda", flush)
    emit({"phase": "kernels", "launch_floor_ms": floor,
          "what": "time_ms of a one-element fill_, L2 flushed: no launch takes less"})
    kernels = {
        "embedding_bag": _embedding_bag_kernel(gen, flush),
        "fm_interaction": _fm_interaction_kernel(gen, flush),
        "augru": _augru_kernel(gen, flush),
        "block_pruned_matmul": _block_pruned_matmul_kernel(gen, flush),
        "local_attention": _local_attention_kernel(gen, flush),
        "int8_matmul": _int8_matmul_kernel(gen, flush),
    }
    for rec in kernels.values():
        rec["launch_floor_ms"] = floor
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


def phase_profile(arch, variant, cfg, params, batches, serve_median_ms, sizes) -> dict:
    """Where a serve call's time goes: the device's busy time and each
    kernel's share of it (torch.profiler). The profiler slows the host
    several-fold, so the idle share is taken against `serve_median_ms`, the
    unprofiled median of the serve phase at the same size. Returns the busy
    ms a call at each size (None where the profiler saw no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy = {}
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
        busy_ms = busy[n] = _busy_ms(spans) / PROFILE_CALLS if spans else None
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
    return busy


def phase_calibrate(arch, cfg, params_by_variant, batches) -> tuple:
    """Each variant's latency curve through `serve.latency_model`, as the
    launcher makes it; the launches are counted from 0 and must equal the
    calls' (a warm call and `SERVE_REPS` timed ones at each size). Returns
    the curves and the launches."""
    t0 = time.perf_counter()
    serve.reset_launch_counts()
    curves = {v: serve.latency_model(p, serve.variant_cfg(v, cfg), batches, SERVE_REPS)
              for v, p in params_by_variant.items()}
    launches = serve.launch_counts()
    calls = (1 + SERVE_REPS) * len(batches)
    expect = {k: calls * sum(EXPECT_LAUNCHES[(arch, v)][k] for v in params_by_variant)
              for k in _NONE}
    emit({"phase": "calibrate", "arch": arch, "reps": SERVE_REPS, "launches": launches,
          "expected": expect, "seconds": time.perf_counter() - t0})
    if launches != expect:
        raise AssertionError(f"{arch} calibration launches {launches}, expected {expect}")
    return curves, launches


def _ratio(a, b):
    """a / b, or None where either is not finite or b is 0 (an unbounded
    `sustainable_rate`)."""
    return a / b if np.isfinite(a) and np.isfinite(b) and b else None


def phase_simulate(arch, curves, busy_512) -> dict:
    """Serve each variant's curve through the launcher's engine
    (`serve.run_engine`, 60 simulated seconds) under `SIM_PROFILES[arch]`,
    check it, and record p99, the sustainable rate and the full-batch rate
    (two replicas closing batches of the engine's `max_batch`) against
    baseline's.
    `busy_512`: {variant: device busy ms a call at 512} where a profile ran.
    Returns {variant: {profile: the run's numbers}}."""
    t0 = time.perf_counter()
    engine = EngineConfig()
    window, full = engine.max_wait_s, engine.max_batch
    runs, rates, full_rates = {}, {}, {}
    for v, lat in curves.items():
        curve_ms = lat.times * 1e3
        if not (np.isfinite(curve_ms).all() and (curve_ms > 0).all()):
            raise AssertionError(f"{arch}/{v}: curve points {curve_ms.tolist()} ms")
        if busy_512.get(v) is not None and lat(512) * 1e3 < busy_512[v]:
            raise AssertionError(f"{arch}/{v}: curve at 512 {lat(512) * 1e3} ms, below the "
                                 f"device's busy time a call, {busy_512[v]} ms")
        spec = ReplicaSpec(v, lat, cold_start_s=5.0, warm_start_s=0.2)
        rates[v] = sustainable_rate(spec, 2, window)
        full_rates[v] = 2 * full / lat(full)
        runs[v] = {}
        for prof in SIM_PROFILES[arch]:
            t1 = time.perf_counter()
            res = serve.run_engine(v, lat, prof)
            rec = {**serve.serving_record(res, lat), **{k: res[k] for k in COUNTS},
                   "seconds": time.perf_counter() - t1}
            if res["arrived"] != res["completed"] + res["rejected"] + res["in_queue"]:
                raise AssertionError(f"{arch}/{v}/{prof}: arrived {res['arrived']} != completed "
                                     f"{res['completed']} + rejected {res['rejected']} + in "
                                     f"queue {res['in_queue']}")
            if prof == REPEAT_PROFILE:
                again = serve.run_engine(v, lat, prof)
                again = {**serve.serving_record(again, lat), **{k: again[k] for k in COUNTS}}
                first = {k: rec[k] for k in again}
                if json.dumps(first, sort_keys=True) != json.dumps(again, sort_keys=True):
                    raise AssertionError(f"{arch}/{v}/{prof}: two runs of one curve differ: "
                                         f"{first} vs {again}")
            runs[v][prof] = rec
        emit({"phase": "simulate", "arch": arch, "variant": v,
              "curve_ms": dict(zip(map(int, lat.sizes), curve_ms.tolist())),
              "latency_1_ms": lat(1) * 1e3, "latency_512_ms": lat(512) * 1e3,
              "device_busy_ms_512": busy_512.get(v), "sustainable_rate": rates[v],
              "max_wait_s": window, "full_batch_rate": full_rates[v], "max_batch": full,
              "profiles": runs[v]})
    base = "baseline"
    emit({"phase": "simulate_vs_baseline", "arch": arch,
          "p99_ms": {v: {p: _ratio(r["p99_ms"], runs[base][p]["p99_ms"]) for p, r in by.items()}
                     for v, by in runs.items()},
          "sustainable_rate": {v: _ratio(rates[v], rates[base]) for v in rates},
          "full_batch_rate": {v: _ratio(full_rates[v], full_rates[base]) for v in rates},
          "paper_claim": "p99 under 0.3 of baseline's and rate over 2x: a record, not a check",
          "seconds": time.perf_counter() - t0})
    return runs


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
    """A tree of card tensors (dicts, tuples) on the host."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(t) for t in tree)
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


def _compare_step(label, before, card, host, grads, zero_grad=(), lr=0.0):
    """Every updated float leaf of the card's step against the CPU's.
    `grads` None: an SGD step at lr 1, whose update is the clipped gradient;
    else the CPU's clipped gradients, for an AdamW step at `lr`, and
    `zero_grad` the leaves whose gradient is zero on both devices."""
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
        elif path in zero_grad:
            row["zero_grad"] = True
            row["ok"] = float(d.max()) <= 2 * lr
        else:
            g = grads[path].abs()
            off = (d > TRAIN_ADAM_ATOL) & (g > TRAIN_ADAM_SMALL_GRAD * g.max())
            row["n_off_rule"], row["n_moved"] = int(off.sum()), int((u > 0).sum())
            row["ok"] = (row["n_off_rule"] <= TRAIN_ADAM_SHARE * row["n_moved"]
                         and float(d.norm()) <= TRAIN_ADAM_NORM_REL * float(u.norm()))
        rows.append(row)
        worst = max(worst, float(d.max()))
    return worst, rows


def _steps_vs_cpu(arch, cfg, tree_name, tree, host_batch, expect) -> None:
    """One SGD step at lr 1, then one AdamW step, from `tree` and the same
    batch on the card and on the CPU, held to phase 5's rule; the card's
    launches in each step must be `expect`."""
    card_batch = {k: v.to("cuda") for k, v in host_batch.items()}
    host_tree = _to_cpu(tree)
    grads, zero_grad = None, ()  # the SGD step runs first and gives the clipped gradients
    for opt_name, opt in (("sgd", sgd(1.0, momentum=0.0)), ("adamw", adamw(LADDER.lr))):
        step = make_train_step(train.make_loss(cfg), opt)
        serve.reset_launch_counts()
        t0 = time.perf_counter()
        card, _, card_m = step(tree, opt.init(tree), card_batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = serve.launch_counts()
        host, _, host_m = step(host_tree, opt.init(host_tree), host_batch)
        t2 = time.perf_counter()
        worst, rows = _compare_step(f"{arch}/{tree_name}/{opt_name}", host_tree, card, host,
                                    grads, zero_grad, LADDER.lr)
        if opt_name == "sgd":
            grads = {path: b - a for (path, b), (_, a) in
                     zip(tree_leaves(host_tree), tree_leaves(host)) if b.is_floating_point()}
            card_grads = {path: (b - a).cpu() for (path, b), (_, a) in
                          zip(tree_leaves(tree), tree_leaves(card)) if b.is_floating_point()}
            floor = TRAIN_ZERO_GRAD_REL * max(float(g.abs().max()) for g in grads.values())
            zero_grad = {path for path, g in grads.items()
                         if max(float(g.abs().max()), float(card_grads[path].abs().max())) <= floor}
            del card_grads
        loss_c, loss_h = float(card_m["loss"]), float(host_m["loss"])
        gn_c, gn_h = float(card_m["grad_norm"]), float(host_m["grad_norm"])
        bad = [r["leaf"] for r in rows if not r["ok"]]
        emit({"phase": "train_vs_cpu", "arch": arch, "tree": tree_name, "optimizer": opt_name,
              "loss_card": loss_c, "loss_cpu": loss_h, "grad_norm_card": gn_c,
              "grad_norm_cpu": gn_h, "max_abs_diff": worst,
              "zero_grad_leaves": sorted("/".join(p) for p in zero_grad), "card_seconds": t1 - t0,
              "cpu_seconds": t2 - t1, "launches": launches, "bad_leaves": bad,
              "leaves": rows})
        if launches != expect:
            raise AssertionError(f"{arch}/{tree_name}: train step launches {launches}, "
                                 f"expected {expect}")
        if bad or abs(loss_c - loss_h) > LOSS_REL * abs(loss_h) or \
                abs(gn_c - gn_h) > GRAD_NORM_REL * gn_h:
            raise AssertionError(f"{arch}/{tree_name}/{opt_name}: card and CPU steps differ: "
                                 f"{bad}, loss {loss_c} vs {loss_h}, gnorm {gn_c} vs {gn_h}")
        del card, host
    del host_tree, grads
    torch.cuda.empty_cache()


def phase_train_vs_cpu(params) -> None:
    """One train step from the same parameters and batch on the card and on
    the CPU: the dense tree and a structured-masked one, AdamW and SGD."""
    cfg = get_config("taobao_ssa")
    host_batch = next(make_data(cfg, serve.TRAIN_BATCH, "cpu")(3))
    masked = pruning.with_block_masks(pruning.prune_tree(
        params, pruning.prune_schedule(LADDER.prune_target, LADDER.prune_rounds)[0],
        structured=True))
    for tree_name, tree in (("dense", params), ("structured", masked)):
        _steps_vs_cpu("taobao_ssa", cfg, tree_name, tree, host_batch,
                      {**_NONE, "embedding_bag": 5,
                       "block_pruned_matmul": 15 if tree_name == "structured" else 0})


def drive_arch(arch: str, variants=None) -> tuple:
    """Serve, profile, calibrate, card-vs-CPU and simulate for one arch at
    full width; returns the kernel launches of its serve and its calibrate
    phase. `variants` are the trees to serve (taobao_ssa: the ladder's); by
    default the arch's own from random weights."""
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
    busy_512 = {}
    for v, vparams in variants.items():
        sizes = (1, max(SIZES)) if v == "baseline" and arch == "taobao_ssa" else (max(SIZES),)
        busy_512[v] = phase_profile(arch, v, serve.variant_cfg(v, cfg), vparams, batches,
                                    serve_median_ms[v], sizes)[max(SIZES)]
    curves, cal_launches = phase_calibrate(arch, cfg, variants, batches)
    phase_card_vs_cpu(arch, cfg, variants, batches[max(SIZES)])
    phase_simulate(arch, curves, busy_512)
    emit({"phase": "arch_done", "arch": arch, "setup_seconds": setup_s,
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del variants, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches, cal_launches


def phase_serve_c2() -> dict:
    """taobao_ssa under the paper's C2 window (`C2_WINDOW`) through the
    launcher's own entry point, `serve.run`, at full width: it pretrains
    (every step's two attentions through the local-attention kernel), runs
    the structured ladder, serves the five variants at every size and
    calibrates each one's curve, which it serves under `REPEAT_PROFILE`.
    The launches are counted from 0 over the whole call and must equal
    training's plus serving's plus calibration's, each worked out from the
    steps and calls. Then, from the launcher's own pretrained parameters
    (pretraining repeats bit for bit): the card against the CPU on
    `baseline` and `quantized`, a window of L = 100 against the unwindowed
    model, a profile of `baseline` at 1 and 512, and the simulate phase on
    the launcher's curves, whose `REPEAT_PROFILE` runs must equal
    `serve.run`'s. Returns the launches."""
    t0 = time.perf_counter()
    base_cfg = get_config("taobao_ssa")
    cfg = with_attn_window(base_cfg, C2_WINDOW)
    dev = torch.device("cuda")
    serve.reset_launch_counts()
    records = serve.run(cfg, sizes=SIZES, device=dev, reps=SERVE_REPS, ladder=LADDER,
                        profile=REPEAT_PROFILE)
    torch.cuda.synchronize()
    launches = serve.launch_counts()
    run_s = time.perf_counter() - t0
    *timed, stats = records
    served = {r["variant"]: r for r in timed if "serving" in r}
    timed = [r for r in timed if "serving" not in r]
    medians = {}
    for r in timed:
        v, n = r["variant"], r["size"]
        medians.setdefault(v, {})[n] = r["median_ms"]
        emit({"phase": "serve", "arch": "taobao_ssa_c2", "attn_window": C2_WINDOW, **r})
        if r["launches_per_call"] != EXPECT_LAUNCHES[("taobao_ssa_c2", v)]:
            raise AssertionError(f"taobao_ssa_c2/{v}@{n}: kernel launches per call "
                                 f"{r['launches_per_call']}, expected "
                                 f"{EXPECT_LAUNCHES[('taobao_ssa_c2', v)]}")
    # serve calls of each variant: timed, then calibrated
    calls = (serve.WARMUP + SERVE_REPS) * len(SIZES) + (1 + SERVE_REPS) * len(SIZES)
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
    busy = phase_profile("taobao_ssa_c2", "baseline", cfg, variants["baseline"], batches,
                         medians["baseline"], (1, max(SIZES)))
    if set(served) != set(medians):
        raise AssertionError(f"serve.run gave curves for {sorted(served)}, not {sorted(medians)}")
    curves = {v: serve.curve_from_record(r["curve"]) for v, r in served.items()}
    runs = phase_simulate("taobao_ssa_c2", curves, {"baseline": busy[max(SIZES)]})
    for v, r in served.items():
        again = {k: runs[v][REPEAT_PROFILE][k] for k in r["serving"]}
        if json.dumps(again, sort_keys=True) != json.dumps(r["serving"], sort_keys=True):
            raise AssertionError(f"taobao_ssa_c2/{v}: serve.run's {REPEAT_PROFILE} run "
                                 f"{r['serving']} and the same curve's again {again} differ")
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


def _same_bits(a, b) -> int:
    """Leaves of two trees (flatten order) that differ in shape, dtype or bits."""
    la, _ = checkpoint.flatten(a)
    lb, _ = checkpoint.flatten(b)
    if len(la) != len(lb):
        raise AssertionError(f"trees of {len(la)} and {len(lb)} leaves")
    return sum(x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _median_ms(fn) -> float:
    """Median ms of `STEP_TIMING_REPS` synchronised calls of `fn`, after a warm one."""
    fn()
    ms = []
    for _ in range(STEP_TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _step_ms(cfg, params, batch) -> dict:
    """An AdamW train step (forward, backward, update) and the loss alone
    under no_grad, in ms."""
    opt = adamw(1e-3)
    loss = train.make_loss(cfg)
    step = make_train_step(loss, opt)
    state = opt.init(params)
    with torch.no_grad():
        forward = _median_ms(lambda: loss(params, batch))
    return {"step_ms": _median_ms(lambda: step(params, state, batch)), "loss_only_ms": forward}


def _augru_grad_ms(B, T, g) -> dict:
    """Median ms of `augru_op` at DIEN's training shapes: the kernel's
    forward alone, and forward plus the plain backward (the recurrence
    recomputed and differentiated) for zx, wh and att."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    zx, wh, h0, att, mask = _augru_inputs(B, T, g, gen)
    leaves = [t.requires_grad_(True) for t in (zx, wh, att)]
    dh = torch.randn((B, g), generator=gen, device="cuda")
    with torch.no_grad():
        forward = _median_ms(lambda: augru_ops.augru_op(zx, wh, h0, att, mask))
    both = _median_ms(lambda: torch.autograd.grad(augru_ops.augru_op(zx, wh, h0, att, mask),
                                                  leaves, dh))
    return {"augru_forward_ms": forward, "augru_forward_backward_ms": both}


def _lm_full_width_steps(arch: str) -> dict:
    """`arch` at full width cut to `LM_TRAIN_LAYERS` layers, bf16, AdamW
    (`LM_TRAIN_LR`) on one batch of `LM_TRAIN_BATCH` rows of 128 tokens,
    `LM_TRAIN_STEPS` steps, each synchronised and timed: the loss must
    fall, as `repro`'s arch smoke test asks of its reduced LMs; then the
    loss alone under no_grad. Returns the launches (none)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    defs = transformer.param_defs(cfg)
    params = init_params(defs, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {k: v.to("cuda") for k, v in next(make_data(cfg, LM_TRAIN_BATCH, "cpu")(0)).items()}
    opt = adamw(LM_TRAIN_LR)
    step = make_train_step(train.make_loss(cfg), opt)
    state = opt.init(params)
    serve.reset_launch_counts()
    losses, ms = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        loss_ms = _median_ms(lambda: transformer.loss(params, batch, cfg))
    launches = serve.launch_counts()
    emit({"phase": "train_full_width", "arch": arch, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": param_count(defs),
          "batch": [LM_TRAIN_BATCH, train.LM_SEQ], "optimizer": "adamw", "lr": LM_TRAIN_LR,
          "losses": losses, "step_ms": ms, "step_ms_median_after_first": float(np.median(ms[1:])),
          "loss_only_ms": loss_ms, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "seconds": time.perf_counter() - t0})
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} full-width training: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{arch} full-width training launched kernels: {launches}")
    del params, state, metrics
    torch.cuda.empty_cache()
    return launches


def phase_train(root: Path) -> dict:
    """The training launcher (`launch/train.run`) on the card for every
    trained arch: crash and resume against an uninterrupted run, bit for
    bit; exact launches; a card checkpoint restored on the CPU; FM's,
    DIEN's, DIN's and AutoInt's steps against the CPU's; then adam8bit.
    Returns the launches of
    each arch's three runs, and of the adam8bit run."""
    by_path = {}
    kw = dict(steps=FT_STEPS, batch=FT_BATCH, optimizer="adamw", lr=1e-3,
              ckpt_every=FT_CKPT_EVERY, device="cuda")
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        crashed, fresh = root / f"{arch}_crashed", root / f"{arch}_whole"
        serve.reset_launch_counts()
        try:
            train.run(arch, ckpt_dir=str(crashed), crash_at=FT_CRASH_AT, **kw)
        except RuntimeError as e:
            if f"injected failure at step {FT_CRASH_AT}" not in str(e):
                raise
        else:
            raise AssertionError(f"{arch}: the run did not crash at step {FT_CRASH_AT}")
        resumed = train.run(arch, ckpt_dir=str(crashed), **kw)
        whole = train.run(arch, ckpt_dir=str(fresh), **kw)
        torch.cuda.synchronize()
        launches = by_path[f"train_launcher_{arch}"] = serve.launch_counts()
        resume_from = FT_CRASH_AT // FT_CKPT_EVERY * FT_CKPT_EVERY
        steps_run = FT_CRASH_AT + (FT_STEPS - resume_from) + FT_STEPS
        # a train step's forward: the serve call's; an LM's launches none
        per_step = STEP_LAUNCHES.get(arch) or EXPECT_LAUNCHES.get((arch, "baseline"), _NONE)
        expect = {k: steps_run * per_step[k] for k in _NONE}
        differ = _same_bits((resumed["params"], resumed["opt_state"]),
                            (whole["params"], whole["opt_state"]))
        final = (whole["params"], whole["opt_state"])
        on_cpu = checkpoint.restore(fresh, FT_STEPS, final, device="cpu")
        cpu_differ = _same_bits(final, on_cpu)
        cfg = train.reduced_config(get_config(arch))
        host_batch = next(make_data(cfg, FT_BATCH, "cpu")(3))
        timing = _step_ms(cfg, whole["params"], {k: v.to("cuda") for k, v in host_batch.items()})
        if arch == "dien":  # launched after the counts are read
            timing.update(_augru_grad_ms(FT_BATCH, cfg.seq_len, cfg.gru_dim))
        losses = whole["losses"] + resumed["losses"]
        emit({"phase": "train", "arch": arch, "steps": FT_STEPS, "batch": FT_BATCH,
              "ckpt_every": FT_CKPT_EVERY, "crash_at": FT_CRASH_AT,
              "restarts": resumed["restarts"], "resumed_steps": resumed["steps"],
              "leaves_differing_resumed_vs_whole": differ,
              "leaves_differing_card_ckpt_on_cpu": cpu_differ,
              "wall_s": whole["wall_s"], "steps_per_s": whole["steps_per_s"], **timing,
              "losses": whole["losses"], "launches": launches, "expected": expect,
              "seconds": time.perf_counter() - t0})
        if not np.isfinite(losses).all():
            raise AssertionError(f"{arch}: a training loss is not finite")
        if resumed["restarts"] != 1 or resumed["steps"] != FT_STEPS or differ:
            raise AssertionError(f"{arch}: the resumed run ({resumed['restarts']} restarts) "
                                 f"differs from the uninterrupted one in {differ} leaves")
        if resumed["losses"] != whole["losses"][resume_from:]:
            raise AssertionError(f"{arch}: the resumed run's losses differ")
        if cpu_differ:
            raise AssertionError(f"{arch}: the card's checkpoint restores on the CPU with "
                                 f"{cpu_differ} leaves differing")
        if launches != expect:
            raise AssertionError(f"{arch} training launches {launches}, expected {expect}")
        if cfg.family == "lm":  # in f32: a bf16 leaf's update lies below its rounding step
            cfg = dataclasses.replace(cfg, dtype="float32")
            _steps_vs_cpu(arch, cfg, "launcher_30_steps_f32",
                          tree_map(lambda t: t.float(), whole["params"]), host_batch, dict(_NONE))
        elif arch != "taobao_ssa":
            _steps_vs_cpu(arch, cfg, "launcher_30_steps", whole["params"], host_batch,
                          {k: per_step[k] for k in _NONE})
        del resumed, whole, final, on_cpu
        torch.cuda.empty_cache()

    for arch in LM_SERVE_ARCHS:
        by_path[f"train_full_width_{arch}"] = _lm_full_width_steps(arch)

    t0 = time.perf_counter()
    serve.reset_launch_counts()
    rec = train.run("taobao_ssa", **{**kw, "steps": ADAM8BIT_STEPS, "optimizer": "adam8bit"},
                    ckpt_dir=str(root / "adam8bit"))
    launches = by_path["train_launcher_adam8bit"] = serve.launch_counts()
    tree = (rec["params"], rec["opt_state"])
    differ = {dev: _same_bits(tree, checkpoint.restore(root / "adam8bit", ADAM8BIT_STEPS, tree,
                                                       device=dev)) for dev in ("cuda", "cpu")}
    codes = [x for x in checkpoint.flatten(rec["opt_state"])[0] if x.dtype == torch.int8]
    expect = {k: ADAM8BIT_STEPS * EXPECT_LAUNCHES[("taobao_ssa", "baseline")][k] for k in _NONE}
    emit({"phase": "train_adam8bit", "arch": "taobao_ssa", "steps": rec["steps"],
          "losses": rec["losses"], "wall_s": rec["wall_s"], "int8_leaves": len(codes),
          "nonzero_codes": int(sum(int((c != 0).sum()) for c in codes)),
          "leaves_differing_after_restore": differ, "launches": launches,
          "seconds": time.perf_counter() - t0})
    if not np.isfinite(rec["losses"]).all() or rec["steps"] != ADAM8BIT_STEPS:
        raise AssertionError(f"adam8bit: losses {rec['losses']}")
    if any(differ.values()) or not codes:
        raise AssertionError(f"adam8bit: the checkpoint restores with {differ} leaves differing")
    if launches != expect:
        raise AssertionError(f"adam8bit training launches {launches}, expected {expect}")
    return by_path


def _e2e_dirs() -> set:
    tmp = Path(tempfile.gettempdir())
    return set(tmp.glob("repro_torch_e2e_ckpt_*"))


def phase_compress_and_serve() -> dict:
    """`launch/compress_and_serve.run(steps=E2E_STEPS)` on the card, with no
    `ckpt_dir`: it checkpoints into a fresh temporary directory, which must
    be gone when it returns. Every stage's record, launches counted from 0
    and worked out from its steps and calls. Returns the launches."""
    t0 = time.perf_counter()
    dirs_before = _e2e_dirs()
    serve.reset_launch_counts()
    records = compress_and_serve.run(steps=E2E_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = serve.launch_counts()
    left = sorted(map(str, _e2e_dirs() - dirs_before))
    for r in records:
        emit({"phase": "compress_and_serve", **r})
    lc, cs = compress_and_serve.LADDER, compress_and_serve
    served = [r for r in records if r["stage"] == "serve"]
    calls = len(cs.SIZES) * (1 + cs.CAL_REPS)  # a warm call and CAL_REPS a size
    bags = 5 * (E2E_STEPS + lc.prune_rounds * lc.finetune_steps + lc.qat_steps) \
        + 10 * lc.distill_steps \
        + calls * sum(EXPECT_LAUNCHES[("taobao_ssa", r["variant"])]["embedding_bag"]
                      for r in served) \
        + 3  # the tier's rows, the cached lookup's reduce, the uncached lookup
    expect = {**_NONE, "embedding_bag": bags}  # unstructured: no block-pruned linear
    train_rec, cache_rec = records[0], records[-1]
    emit({"phase": "compress_and_serve_launches", "launches": launches, "expected": expect,
          "stage_seconds": {r["stage"] + (f"_{r['variant']}" if "variant" in r else ""):
                            r["seconds"] for r in records},
          "checkpoint_dirs_left": left, "seconds": time.perf_counter() - t0})
    if left:
        raise AssertionError(f"compress_and_serve left its checkpoint directories {left}")
    if train_rec["steps"] != E2E_STEPS or train_rec["restarts"] or \
            not np.isfinite(train_rec["losses"]).all():
        raise AssertionError(f"compress_and_serve training: {train_rec}")
    if len(served) != 5 or not all(np.isfinite([r["p99_ms"], r["latency_512_ms"]]).all()
                                   for r in served):
        raise AssertionError(f"compress_and_serve served {served}")
    if [row["cache"] for row in cache_rec.get("rows", [])] != ["none", "lru_warm"]:
        raise AssertionError(f"compress_and_serve cache rows {cache_rec}")
    if launches != expect:
        raise AssertionError(f"compress_and_serve launches {launches}, expected {expect}")
    torch.cuda.empty_cache()
    return launches


def phase_quickstart() -> dict:
    """`launch/quickstart` at the example's defaults on the card: its
    stages through `build`, `scores` and `table` (what `run` composes),
    launches counted from 0 and worked out from the steps and calls; then
    each variant's evaluation scores against the CPU's plain path from the
    same parameters. Returns the launches."""
    t0 = time.perf_counter()
    serve.reset_launch_counts()
    q = quickstart.build("cuda")
    t1 = time.perf_counter()
    by_variant = quickstart.scores(q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = serve.launch_counts()
    rows = quickstart.table(q, by_variant)
    lc = quickstart.LADDER
    fine = lc.prune_rounds * lc.finetune_steps + lc.qat_steps  # steps through the teacher's lookups
    scored = sum(EXPECT_LAUNCHES[("taobao_ssa", v)]["embedding_bag"] for v in q.variants)
    expect = {**_NONE, "embedding_bag": 5 * (quickstart.STEPS + fine) + 10 * lc.distill_steps
              + scored}  # distillation: the teacher's lookups and the student's
    cpu_batch = {k: v.cpu() for k, v in q.eval_batch.items()}
    diffs = {}
    with torch.no_grad():
        for name, v in q.variants.items():
            host = api.serve(_to_cpu(v["params"]), cpu_batch, v["cfg"])
            diffs[name] = float((by_variant[name].cpu() - host).abs().max())
    t3 = time.perf_counter()
    emit({"phase": "quickstart", "vocab": quickstart.VOCAB, "world": quickstart.WORLD,
          "steps": quickstart.STEPS, "batch": quickstart.BATCH,
          "ladder": dataclasses.asdict(lc), "queries": quickstart.N_QUERIES,
          "candidates": quickstart.N_CAND, "losses": q.losses, "rows": rows,
          "card_vs_cpu_max_abs_diff": diffs, "tol": PROB_TOL, "launches": launches,
          "expected": expect, "stage_seconds": {**q.seconds, "score": t2 - t1,
                                                "cpu_score": t3 - t2},
          "seconds": t3 - t0})
    if len(q.losses) != quickstart.STEPS or not np.isfinite(q.losses).all():
        raise AssertionError(f"quickstart training losses {q.losses}")
    if [r["variant"] for r in rows] != list(serve.VARIANTS):
        raise AssertionError(f"quickstart rows {rows}")
    for r in rows:
        m = [r[k] for k in ("HR@10", "NDCG@50", "MRR")]
        if not (np.isfinite(m).all() and all(0 <= x <= 1 for x in m)):
            raise AssertionError(f"quickstart metrics {r}")
    bad = {v: d for v, d in diffs.items() if not d <= PROB_TOL}
    if bad:
        raise AssertionError(f"quickstart scores: card and CPU differ by {bad}")
    if launches != expect:
        raise AssertionError(f"quickstart launches {launches}, expected {expect}")
    del q, by_variant
    torch.cuda.empty_cache()
    return launches


def _lm_flops_bytes(cfg, batch: int, seq: int, experts=None) -> dict:
    """What a prefill of `batch` x `seq` tokens must compute and move, and
    what one decode step of `batch` tokens at a cache of `seq` positions
    must read, on this run's data:
    - prefill FLOPs: 2 a weight a token over the layer weights each token
      uses (attention, a dense FFN, or router + top_k experts + shared
      ones), the last position's logits (2·B·V·D), and causal attention
      (QKᵀ and PV over the S(S+1)/2 pairs a row needs); prefill bytes:
      every weight read once, the embedding rows, the caches written;
    - decode bytes: the layer weights the step reads (an MoE layer's
      experts: `experts[i]`, those the step's tokens chose in MoE layer i,
      the configured top_k when not given), the output table, the
      embedding rows, and the caches' keys and values up to `seq`
      positions; decode FLOPs: 2 a weight a token."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n_super, n_dense, n_moe = transformer._moe_layout(cfg)
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    ffn = 3 * D * cfg.d_ff
    used = stored = step_read = 0
    moe_i = 0
    for _ in range(n_super):
        for j in range(n_dense + n_moe if cfg.n_experts else 1):
            if cfg.n_experts and (cfg.moe_interleave == 1 or j == 1):
                always = attn + cfg.n_shared_experts * ffn + D * cfg.n_experts
                chosen = cfg.top_k if experts is None else experts[moe_i]
                moe_i += 1
                used += always + cfg.top_k * ffn
                stored += always + cfg.n_experts * ffn
                step_read += always + chosen * ffn
            else:
                used, stored, step_read = used + attn + ffn, stored + attn + ffn, \
                    step_read + attn + ffn
    elem = 2 if cfg.dtype == "bfloat16" else 4
    tokens, table = batch * seq, cfg.vocab_size * D
    cache = cfg.n_layers * 2 * K * hd * elem  # bytes of keys and values a position a row
    return {
        "prefill_flops": 2 * tokens * used + 2 * batch * table
        + cfg.n_layers * 4 * batch * H * hd * seq * (seq + 1) // 2,
        "prefill_bytes": elem * (stored + table + tokens * D) + tokens * cache,
        "decode_bytes": elem * (step_read + table + batch * D) + batch * seq * cache,
        "decode_flops": 2 * batch * (used + table)}


def _lm_bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _timed(fn):
    """(fn(), ms): `fn` between two synchronisations of the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _in_cache(cfg, kv, T):
    """Prefilled caches (k, v) [L,B,S,K,hd] placed at the start of zeroed
    caches of T positions."""
    out = []
    for c in kv:
        full = torch.zeros(transformer.cache_shape(cfg, c.shape[1], T), dtype=c.dtype,
                           device=c.device)
        full[:, :, :c.shape[2]] = c
        out.append(full)
    return tuple(out)


def _decode_steps(params, cache, token, start, n, cfg, stats=None):
    """`n` greedy decode steps from position `start`, each timed alone:
    (the steps' logits, their ms, the last cache)."""
    logits, ms = [], []
    for i in range(n):
        pos = torch.full((token.shape[0],), start + i, dtype=torch.int64, device=token.device)
        (lg, cache), t = _timed(lambda: transformer.decode(params, cache, token, pos, cfg, stats))
        logits.append(lg)
        ms.append(t)
        token = torch.argmax(lg, -1)
    return logits, ms, cache


def _rel_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / a.float().abs().max())


def _lm_card_vs_cpu(arch: str) -> dict:
    """`arch` at full width with `LM_CPU_LAYERS` layers in f32 (TF32 is off
    since phase 1) from seed 0 on the card and the same weights on the CPU,
    on `LM_CPU_TOKENS`: prefill logits, `LM_CPU_DECODE` decode steps fed
    the card's greedy tokens, and the loss, within `LM_CARD_CPU_TOL`."""
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_CPU_LAYERS, dtype="float32")
    card = init_params(transformer.param_defs(cfg), torch.Generator(device="cuda").manual_seed(1),
                       "cuda")
    host = _to_cpu(card)
    B, S = LM_CPU_TOKENS
    batch = next(synthetic.lm_token_batches(cfg.vocab_size, B, S, 1, seed=1))
    out = {}
    t0 = time.perf_counter()
    for side, dev, params in (("card", "cuda", card), ("cpu", "cpu", host)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            loss, _ = transformer.loss(params, b, cfg)
            logits, kv = transformer.prefill(params, b["tokens"], cfg)
            cache = _in_cache(cfg, kv, S + LM_CPU_DECODE)
            steps, token = [], torch.argmax(logits, -1)
            for i in range(LM_CPU_DECODE):
                if side == "cpu":  # the card's greedy tokens
                    token = out["card"]["tokens"][i].to(dev)
                pos = torch.full((B,), S + i, dtype=torch.int64, device=dev)
                lg, cache = transformer.decode(params, cache, token, pos, cfg)
                steps.append(lg.cpu())
                token = torch.argmax(lg, -1)
        logits = [logits.cpu()] + steps
        out[side] = {"loss": float(loss), "logits": logits,
                     "tokens": [torch.argmax(x, -1) for x in logits]}
    diffs = [_rel_diff(h, c) for h, c in zip(out["cpu"]["logits"], out["card"]["logits"])]
    loss_rel = abs(out["card"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    rec = {"n_layers": cfg.n_layers, "dtype": cfg.dtype, "tokens": [B, S],
           "loss_card": out["card"]["loss"], "loss_cpu": out["cpu"]["loss"],
           "loss_rel_diff": loss_rel, "prefill_rel_diff": diffs[0], "decode_rel_diffs": diffs[1:],
           "tol": LM_CARD_CPU_TOL, "seconds": time.perf_counter() - t0}
    if max(diffs + [loss_rel]) > LM_CARD_CPU_TOL:
        raise AssertionError(f"{arch}: card and CPU differ: {rec}")
    del card, host
    torch.cuda.empty_cache()
    return rec


def phase_lm_serve(arch: str) -> dict:
    """`arch` as configured, at full width and depth, bf16, from seed 0 on
    the card: prefill `LM_BATCH` x `LM_PREFILL` tokens (`attn_impl`
    "chunked": KV chunks of `q_chunk`), the caches placed in `LM_CACHE`
    positions, `LM_DECODE_STEPS` greedy decode steps; each timed beside
    its bound. Dense archs also: decode against a longer prefill, the C2
    decode at the default window against the dense one, and the C2 decode
    under `LM_C2_OVERRIDES` timed. MoE archs: the entries each capacity
    stage of the prefill's dispatch dropped. Then the card against the CPU
    (`_lm_card_vs_cpu`). Returns the launches (none)."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    defs = transformer.param_defs(cfg)
    params = init_params(defs, torch.Generator(device="cuda").manual_seed(0), "cuda")
    weights_bytes = torch.cuda.memory_allocated() - mem0
    batch = next(synthetic.lm_token_batches(cfg.vocab_size, LM_BATCH, LM_PREFILL, 1, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to("cuda")
    serve.reset_launch_counts()
    rec = {"phase": "lm_serve", "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "dtype": cfg.dtype, "attn_impl": cfg.attn_impl,
           "kv_chunk": cfg.q_chunk, "params_config": cfg.param_count(),
           "params_active_config": cfg.active_param_count(), "params_defs": param_count(defs),
           "weights_bytes": weights_bytes, "batch": LM_BATCH, "prefill_tokens": LM_PREFILL,
           "cache_positions": LM_CACHE, "decode_steps": LM_DECODE_STEPS}
    with torch.no_grad():
        stats = {}
        transformer.prefill(params, tokens, cfg, stats)  # warm, and the dispatch's record
        if cfg.n_experts:
            rec["prefill_dropped"] = {k: int(sum(int(n) for n in v)) for k, v in stats.items()}
            rec["prefill_entries"] = cfg.n_layers * LM_BATCH * LM_PREFILL * cfg.top_k
        runs = [_timed(lambda: transformer.prefill(params, tokens, cfg))
                for _ in range(LM_PREFILL_REPS)]
        logits, kv = runs[-1][0]
        prefill_ms = float(np.median([t for _, t in runs]))
        cache = _in_cache(cfg, kv, LM_CACHE)
        del kv, runs
        token = torch.argmax(logits, -1)
        steps, ms, _ = _decode_steps(params, cache, token, LM_PREFILL, LM_DECODE_STEPS, cfg)
        experts = None
        if cfg.n_experts:  # the same steps again, untimed, for the experts each one chose
            stats = {}
            _decode_steps(params, cache, token, LM_PREFILL, LM_DECODE_STEPS, cfg, stats)
            per_step = torch.stack(stats["experts"]).view(LM_DECODE_STEPS, cfg.n_layers).cpu()
            experts = per_step.float().mean(0).tolist()  # the mean over the steps, a layer
            rec["decode_experts_chosen_mean"] = float(per_step.float().mean())
            rec["decode_dropped"] = int(sum(int(n) for n in stats["dropped"]))
    decode_ms = float(np.median(ms))
    work = _lm_flops_bytes(cfg, LM_BATCH, LM_PREFILL)
    dwork = _lm_flops_bytes(cfg, LM_BATCH, LM_PREFILL + LM_DECODE_STEPS // 2, experts)
    p_bound, p_by = _lm_bound_ms(work["prefill_flops"], work["prefill_bytes"])
    d_bound, d_by = _lm_bound_ms(dwork["decode_flops"], dwork["decode_bytes"])
    rec.update({
        "prefill_ms": prefill_ms, "prefill_tokens_per_s":
            LM_BATCH * LM_PREFILL / prefill_ms * 1e3, "prefill_flops": work["prefill_flops"],
        "prefill_bytes": work["prefill_bytes"],
        "prefill_bound_ms": p_bound, "prefill_bound_by": p_by,
        "decode_ms_median": decode_ms, "decode_ms_first": ms[0], "decode_ms_max": max(ms),
        "decode_tokens_per_s": LM_BATCH / decode_ms * 1e3, "decode_bytes": dwork["decode_bytes"],
        "decode_bound_ms": d_bound, "decode_bound_by": d_by,
        "peak_bf16_flops": H100_BF16_FLOPS, "hbm_bytes_per_s": H100_HBM_BYTES_PER_S})
    finite = all(torch.isfinite(x).all() for x in [logits] + steps)
    if not cfg.n_experts:
        rec.update(_lm_dense_checks(params, cfg, tokens, cache, token))
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    rec["launches"] = serve.launch_counts()
    del params, cache, logits, steps
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = _lm_card_vs_cpu(arch)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not finite or not rec.get("c2_finite", True):
        raise AssertionError(f"{arch}: logits not finite")
    if rec["params_defs"] != rec["params_config"]:
        raise AssertionError(f"{arch}: param_defs holds {rec['params_defs']} parameters, "
                             f"the config {rec['params_config']}")
    for key in ("decode_vs_prefill_rel_diff", "c2_default_vs_dense_rel_diff"):
        if key in rec and not rec[key] <= LM_DECODE_TOL:
            raise AssertionError(f"{arch}: {key} {rec[key]} above {LM_DECODE_TOL}")
    if any(rec["launches"].values()):
        raise AssertionError(f"{arch}: the LM path launched kernels: {rec['launches']}")
    return rec["launches"]


def _lm_dense_checks(params, cfg, tokens, cache, token) -> dict:
    """Decode against prefill: the caches of a prefill of `LM_CHECK_S` - 1
    tokens in `LM_CHECK_S` positions, token `LM_CHECK_S` - 1 decoded at
    that position, against the last position of a prefill of all
    `LM_CHECK_S` (at most one KV chunk: dense attention); the C2 decode at
    the config's window (4,096 >= `LM_CHECK_S`: every global sample a
    duplicate) against that dense decode; and `LM_DECODE_STEPS` C2 steps
    under `LM_C2_OVERRIDES` from position `LM_PREFILL`, timed."""
    n = LM_CHECK_S
    with torch.no_grad():
        full, _ = transformer.prefill(params, tokens[:, :n], cfg)
        _, kv = transformer.prefill(params, tokens[:, :n - 1], cfg)
        short = _in_cache(cfg, kv, n)
        del kv
        pos = torch.full((tokens.shape[0],), n - 1, dtype=torch.int64, device="cuda")
        dense, _ = transformer.decode(params, short, tokens[:, n - 1], pos, cfg)
        c2 = dataclasses.replace(cfg, sparse_attention=True)
        hybrid, _ = transformer.decode(params, short, tokens[:, n - 1], pos, c2)
        c2_small = dataclasses.replace(c2, **LM_C2_OVERRIDES)
        steps, ms, _ = _decode_steps(params, cache, token, LM_PREFILL, LM_DECODE_STEPS, c2_small)
    c2_ms = float(np.median(ms))
    return {"decode_vs_prefill_positions": n, "decode_vs_prefill_rel_diff": _rel_diff(full, dense),
            "c2_default_window": cfg.attn_window, "c2_default_n_global": cfg.attn_n_global,
            "c2_default_vs_dense_rel_diff": _rel_diff(dense, hybrid), "tol": LM_DECODE_TOL,
            "c2_overrides": LM_C2_OVERRIDES, "c2_decode_ms_median": c2_ms,
            "c2_decode_tokens_per_s": tokens.shape[0] / c2_ms * 1e3,
            "c2_finite": bool(all(torch.isfinite(x).all() for x in steps))}

def gnn_batch(name: str) -> dict:
    """numpy inputs of a dry-run GNN shape (`configs/shapes.GNN_SHAPES`),
    seed 0. molecule: `molecule_batch` of 128 molecules of 30 atoms and 64
    edges. full_graph_sm: a Cora-sized `random_graph` (2,708 nodes, 1,433
    features, 7 classes) at degree 4, cut to Cora's 10,556 edges.
    minibatch_lg: `sample_subgraph` of 1,024 distinct seeds at fanout
    (15, 10) in a host CSR of a `random_graph` with Reddit's 232,965 nodes,
    602 features and 41 classes at the launcher's degree 8 (Reddit's is
    492; the sampler draws with replacement, so the card's shapes do not
    depend on it); its nodes' positions, features and labels gathered on
    the host, the seeds' labels alone counted (`label_mask`)."""
    s = GNN_SHAPES[name]
    if s.kind == "batched_small":
        return synthetic.molecule_batch(s.graph_batch, s.n_nodes, s.n_edges, seed=0)
    if s.kind == "full_batch":
        g = synthetic.random_graph(s.n_nodes, -(-s.n_edges // s.n_nodes), d_feat=s.d_feat,
                                   n_classes=GNN_CLASSES[name], seed=0)
        return {**g, "edge_src": g["edge_src"][:s.n_edges], "edge_dst": g["edge_dst"][:s.n_edges]}
    host = synthetic.random_graph(s.n_nodes, train.GNN_DEGREE, d_feat=s.d_feat,
                                  n_classes=GNN_CLASSES[name], seed=0)
    csr = sampler.CSRGraph.from_edges(host["edge_src"], host["edge_dst"], s.n_nodes)
    rng = np.random.default_rng(0)
    sub = sampler.sample_subgraph(csr, rng.choice(s.n_nodes, s.batch_nodes, replace=False),
                                  s.fanout, rng)
    ids = sub["node_ids"]
    return {"positions": host["positions"][ids], "features": host["features"][ids],
            "labels": host["labels"][ids], "edge_src": sub["edge_src"],
            "edge_dst": sub["edge_dst"], "label_mask": sub["seed_mask"]}


def gnn_flops_bytes(cfg, name: str, batch: dict, params: dict) -> dict:
    """The least work of a NequIP step on `batch`: operations of the
    forward (multiply-adds as 2), 3x for forward and backward, and the
    bytes a step must move (its inputs read once: parameters, AdamW's two
    moments, the batch; parameters and moments written once). Per edge and
    channel a coupling path is, for the edge's fixed harmonics, a
    (2l_out+1) x (2l_in+1) map: 2·d_out·d_in, then 2·d_out to weight and
    add it; the radial MLP, self-interactions, gates, input projection and
    head are their matmuls. Scatters add E·C·9; geometry and elementwise
    gates are counted at their outputs."""
    N, E = batch["positions"].shape[0], batch["edge_src"].shape[0]
    C, R, H, K = cfg.d_hidden, cfg.n_rbf, nequip.RAD_HIDDEN, GNN_CLASSES[name]
    per_edge_channel = sum(2 * (2 * lo + 1) * (2 * lf + 1) + 2 * (2 * lo + 1)
                           for lf, _, lo, _ in nequip.path_list())
    layer = (2 * E * (R * H + H * nequip.N_PATHS * C) + E * C * per_edge_channel
             + E * C * 9 + 2 * N * C * C * 9 + 2 * N * C * 2 * C + N * C * 18)
    fwd = cfg.n_layers * layer + 2 * N * C * (C + K) + E * 40 + E * R * 8
    if "features" in batch:
        fwd += 2 * N * batch["features"].shape[1] * C
    n_param = sum(int(t.numel()) for _, t in tree_leaves(params))
    batch_bytes = sum(int(np.asarray(v).nbytes) for v in batch.values())
    return {"forward_flops": float(fwd), "step_flops": float(3 * fwd),
            "step_bytes": float(6 * 4 * n_param + batch_bytes),
            "loss_bytes": float(4 * n_param + batch_bytes)}


def _gnn_bound_ms(flops: float, nbytes: float) -> tuple:
    """(ms, "operations" | "bytes"): f32 on CUDA cores (TF32 is off) and HBM."""
    ops_ms, bytes_ms = flops / H100_F32_FLOPS * 1e3, nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _rotation(seed: int) -> np.ndarray:
    """A rotation matrix from a normal quaternion, f32."""
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def _gather_routes_ms(params, batch, cfg) -> dict:
    """The node-feature gathers of one forward (`hoist_gathers` off: 15 a
    layer, 3 of l=0, 6 of l=1 and 6 of l=2, over 5 layers) with their
    backward, at this batch's edges, two ways: `nequip.gather` (index_select,
    its backward the fixed-order reduce over one grouping of the edges made
    once a forward; the port's) and `embedding_bag_op` at one id a bag on
    the [N, C·(2l+1)] view (the kernel, its backward `_table_grad`, which
    sorts the ids at every call). The two gradients must be the same bits."""
    N, C = batch["positions"].shape[0], cfg.d_hidden
    src = batch["edge_src"]
    per_l = {0: 3, 1: 6, 2: 6}
    order = [l for _ in range(cfg.n_layers) for l in per_l for _ in range(per_l[l])]
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn((N, C, 2 * l + 1), generator=gen, device="cuda").requires_grad_(True)
          for l in per_l]
    dys = [torch.randn((src.shape[0], C, 2 * l + 1), generator=gen, device="cuda") for l in per_l]
    ids = src.to(torch.int32).reshape(-1, 1).contiguous()

    def run(gather):
        return torch.autograd.grad([gather(l) for l in order], xs, [dys[l] for l in order])

    def port():
        seg = eb_ops.segments(src, N)
        return run(lambda l: nequip.gather(xs[l], seg))

    def kernel():
        return run(lambda l: eb_ops.embedding_bag_op(xs[l].reshape(N, -1), ids).reshape(
            -1, C, 2 * l + 1))

    same = all(torch.equal(a, b) for a, b in zip(port(), kernel()))
    rec = {"gathers": len(order), "port_gather_ms": _median_ms(port),
           "embedding_bag_route_ms": _median_ms(kernel), "kernel_route_same_gradient_bits": same}
    del xs, dys
    if not same:
        raise AssertionError("the two gather routes' gradients differ")
    return rec


def _profile_step(fn, unprofiled_ms: float) -> dict:
    """One call of `fn` under torch.profiler after a warm one: the device's
    busy ms, its idle share against `unprofiled_ms` (the profiler slows
    the host), the device ops and the six costliest kernels by ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in kernels]) if kernels else None
    return {"device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / unprofiled_ms,
            "device_ops": len(kernels),
            "top_ms": [[k[:80], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]]}


def _gnn_steps(params, batch, loss, steps) -> tuple:
    """`steps` AdamW steps (lr `GNN_LR`) on one batch from `params`:
    (params, opt_state, losses, each step's ms)."""
    opt = adamw(GNN_LR)
    step = make_train_step(loss, opt)
    state, losses, ms = opt.init(params), [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return params, state, losses, ms


def _ogb_products_reckoning(cfg) -> dict:
    """Bytes one f32 tensor of ogb_products' edges takes as `repro` computes
    a layer: a message [E, C, 5] and `_p222`'s [E, C, 3, 3] matrices."""
    s = GNN_SHAPES["ogb_products"]
    return {"shape": "ogb_products", "run": False, "nodes": s.n_nodes, "edges": s.n_edges,
            "message_l2_bytes": s.n_edges * cfg.d_hidden * 5 * 4,
            "p222_matrix_bytes": s.n_edges * cfg.d_hidden * 9 * 4,
            "card_bytes": torch.cuda.get_device_properties(0).total_memory,
            "reason": "one [E, 32, 5] f32 message is 39.6 GB and each of _p222's two "
                      "[E, 32, 3, 3] matrices 71.3 GB: one card cannot hold a layer of it; it "
                      "waits for the sharded modules (four cards) or an edge-chunked forward"}


def phase_gnn_full_size(name: str) -> dict:
    """NequIP as configured (5 layers, 32 channels, l_max 2, f32) from seed
    0 at one dry-run shape: the forward on the card against the CPU's
    (molecule, full_graph_sm), a rotation of the positions against none,
    8 AdamW steps on the batch twice from the same start (the loss must
    fall; the two must end in the same bits), then a step's and the loss's
    median ms beside their bounds, the gathers' two routes, and
    `max_memory_allocated`. Returns the 8 steps' launches."""
    t0 = time.perf_counter()
    cfg = get_config("nequip")
    host = gnn_batch(name)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda") for k, v in host.items()}
    d_feat = host["features"].shape[1] if "features" in host else None
    defs = nequip.param_defs(cfg, d_feat=d_feat, n_classes=GNN_CLASSES[name])
    params = init_params(defs, torch.Generator(device="cuda").manual_seed(0), "cuda")
    loss = (lambda p, b: nequip.energy_loss(p, b, cfg)) if name == "molecule" else \
        (lambda p, b: nequip.node_class_loss(p, b, cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"phase": "gnn_full_size", "shape": name, "nodes": int(host["positions"].shape[0]),
           "edges": int(host["edge_src"].shape[0]), "d_feat": d_feat,
           "classes": GNN_CLASSES[name], "params": param_count(defs),
           "loss": "energy_loss" if name == "molecule" else "node_class_loss"}
    with torch.no_grad():
        out = nequip.forward(params, batch, cfg)
        R = torch.from_numpy(_rotation(0)).to("cuda")
        rotated = nequip.forward(params, {**batch, "positions": batch["positions"] @ R.T}, cfg)
        scale = float(out.abs().max())
        rec["rotation_rel_diff"] = float((rotated - out).abs().max()) / scale
        if name != "minibatch_lg":
            cpu = nequip.forward(_to_cpu(params), {k: torch.from_numpy(np.ascontiguousarray(v))
                                                   for k, v in host.items()}, cfg)
            rec["card_vs_cpu_rel_diff"] = float((out.cpu() - cpu).abs().max()) / scale
    rec.update({"out_shape": list(out.shape), "out_finite": bool(torch.isfinite(out).all()),
                "largest_output": scale, "rotation_tol": GNN_ROT_TOL,
                "card_vs_cpu_tol": GNN_CARD_CPU_TOL})
    del out, rotated

    serve.reset_launch_counts()
    first = _gnn_steps(params, batch, loss, GNN_STEPS)
    torch.cuda.synchronize()
    launches = serve.launch_counts()
    again = _gnn_steps(params, batch, loss, GNN_STEPS)
    differ = _same_bits(first[:2], again[:2])
    rec.update({"steps": GNN_STEPS, "lr": GNN_LR, "losses": first[2], "step_ms_first_run": first[3],
                "leaves_differing_between_runs": differ, "launches": launches})
    del first, again

    opt = adamw(GNN_LR)
    step = make_train_step(loss, opt)
    state = opt.init(params)
    rec["step_ms"] = _median_ms(lambda: step(params, state, batch))
    with torch.no_grad():
        rec["loss_only_ms"] = _median_ms(lambda: loss(params, batch))
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    rec["step_profile"] = _profile_step(lambda: step(params, state, batch), rec["step_ms"])
    work = gnn_flops_bytes(cfg, name, host, params)
    step_bound, step_by = _gnn_bound_ms(work["step_flops"], work["step_bytes"])
    loss_bound, loss_by = _gnn_bound_ms(work["forward_flops"], work["loss_bytes"])
    rec.update({**work, "step_bound_ms": step_bound, "step_bound_by": step_by,
                "loss_bound_ms": loss_bound, "loss_bound_by": loss_by,
                "step_over_bound": rec["step_ms"] / step_bound})
    rec.update(_gather_routes_ms(params, batch, cfg))
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)

    expect = {**_NONE, "embedding_bag": GNN_STEPS if d_feat is None else 0}
    if not (rec["out_finite"] and np.isfinite(rec["losses"]).all()
            and rec["losses"][-1] < rec["losses"][0]):
        raise AssertionError(f"gnn {name}: outputs not finite or the loss did not fall: "
                             f"{rec['losses']}")
    if differ:
        raise AssertionError(f"gnn {name}: two runs from the same start differ in {differ} leaves")
    if not rec["rotation_rel_diff"] <= GNN_ROT_TOL:
        raise AssertionError(f"gnn {name}: a rotation moves the outputs by "
                             f"{rec['rotation_rel_diff']} of the largest")
    if not rec.get("card_vs_cpu_rel_diff", 0.0) <= GNN_CARD_CPU_TOL:
        raise AssertionError(f"gnn {name}: card and CPU differ by {rec['card_vs_cpu_rel_diff']}")
    if launches != expect:
        raise AssertionError(f"gnn {name}: launches {launches}, expected {expect}")
    del params, state, batch
    torch.cuda.empty_cache()
    return launches



def _moe_layer(arch: str, gen):
    """`arch`'s MoE layer as configured, bf16: the defs of one stacked
    layer and weights drawn in bf16 in place (std 1/√fan_in, `fan_in`'s
    rule), without the f32 copy `init_params` would make of 32 GB."""
    cfg = get_config(arch)
    defs = moe_lib.moe_param_defs(cfg, 1, torch.bfloat16)
    params = {k: torch.empty(d.shape, dtype=d.dtype, device="cuda").normal_(
        0.0, 1.0 / math.sqrt(d.shape[-2]), generator=gen) for k, d in sorted(defs.items())}
    return cfg, defs, params


def _ep_run(x, lp, cfg, mesh, cot=None):
    """`moe_ffn_ep` once: (out, aux, [dropped_pair, dropped_expert], the
    gradients of Σ out·cot + aux for x and each weight, or None)."""
    stats = {}
    out, aux = expert_parallel.moe_ffn_ep(x, lp, cfg, stats, mesh=mesh)
    drops = [int(stats["dropped_pair"][0]), int(stats["dropped_expert"][0])]
    grads = None
    if cot is not None:  # world size 1: aux enters each rank's loss as aux / 1
        leaves = [x] + [lp[k] for k in sorted(lp)]
        grads = torch.autograd.grad(torch.sum(out.float() * cot) + aux, leaves)
    return out, aux, drops, grads


def _ep_bound(cfg, tokens: int, kept: int, weight_bytes: int, backward: bool) -> dict:
    """The MoE layer's least time on the card: the operations of the
    entries this run's data keeps (each a SwiGLU of three [d_model, d_ff]
    matmuls, 2 operations a multiply-add; the shared expert on every token;
    the backward twice the forward's) at the bf16 rate, against reading the
    weights (and writing their gradients) and the tokens in and out at the
    HBM rate. Capacity padding is not work."""
    per_row = 3 * 2 * cfg.d_model * cfg.d_ff
    flops = (kept + tokens * cfg.n_shared_experts) * per_row * (3 if backward else 1)
    act = tokens * cfg.d_model * 2 * (4 if backward else 2)  # x, out (+ cot, dx)
    nbytes = weight_bytes * (2 if backward else 1) + act
    ms = {"operations": flops / H100_BF16_FLOPS * 1e3, "bytes": nbytes / H100_HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return {"flops": flops, "bytes": nbytes, "bound_ms": ms[by], "bound_by": by}


def _ep_moe(arch: str, mesh) -> dict:
    """One MoE layer through the mesh and through the one-group path: the
    same bits (deterministic algorithms on, so that every scatter-add of
    the backward sums in one order), then each path's median ms and peak
    memory with PyTorch's default algorithms."""
    batch, seq, backward = DIST_MOE[arch]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg, _, params = _moe_layer(arch, gen)
    lp = {k: v[0].detach().requires_grad_(backward) for k, v in params.items()}
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_(backward)
    cot = torch.randn(x.shape, generator=gen, device="cuda") if backward else None
    paths = {"one_group": None, "mesh": mesh}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.set_grad_enabled(backward):
            runs = {name: _ep_run(x, lp, cfg, m, cot) for name, m in paths.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    (o1, a1, d1, g1), (o2, a2, d2, g2) = runs["one_group"], runs["mesh"]
    differ = int(not torch.equal(o1, o2)) + int(not torch.equal(a1, a2))
    if backward:
        differ += sum(not torch.equal(a, b) for a, b in zip(g1, g2))
    rec = {"phase": "distributed", "part": "moe", "arch": arch, "tokens": [batch, seq],
           "d_model": cfg.d_model, "n_experts": cfg.n_experts, "top_k": cfg.top_k,
           "d_ff": cfg.d_ff, "n_shared_experts": cfg.n_shared_experts, "dtype": "bfloat16",
           "expert_weight_bytes": sum(params[k].numel() * 2 for k in ("w_gate", "w_up", "w_down")),
           "aux": float(a1.detach()), "dropped": {"one_group": d1, "mesh": d2},
           "outputs_and_grads_differing": differ}
    weight_bytes = sum(v.numel() * 2 for k, v in params.items() if k != "router")
    kept = batch * seq * cfg.top_k - sum(d1)
    rec["forward_bound"] = _ep_bound(cfg, batch * seq, kept, weight_bytes, False)
    if backward:
        rec["forward_backward_bound"] = _ep_bound(cfg, batch * seq, kept, weight_bytes, True)
    del runs, o1, o2, g1, g2
    for name, m in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            rec[f"{name}_forward_ms"] = _median_ms(lambda: expert_parallel.moe_ffn_ep(
                x, lp, cfg, mesh=m))
        if backward:
            rec[f"{name}_forward_backward_ms"] = _median_ms(lambda: _ep_run(x, lp, cfg, m, cot))
        rec[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec[f"{name}_forward_over_bound"] = (rec[f"{name}_forward_ms"]
                                             / rec["forward_bound"]["bound_ms"])
        if backward:
            rec[f"{name}_forward_backward_over_bound"] = (
                rec[f"{name}_forward_backward_ms"] / rec["forward_backward_bound"]["bound_ms"])
    emit(rec)
    if differ or d1 != d2:
        raise AssertionError(f"{arch}: the mesh path and the one-group path differ: {rec}")
    grads = None
    if backward:  # the weights' gradients, f32, for the compression part
        _, _, _, g = _ep_run(x, lp, cfg, mesh, cot)
        grads = {k: t.float() for k, t in zip(sorted(lp), g[1:])}
    del params, lp, x, cot
    torch.cuda.empty_cache()
    return grads


def _compression(grads: dict, group) -> dict:
    """`compress_allreduce_mean` over NCCL on `grads`: one step against the
    CPU's `_dq(_q(g + r))` to the bit, then `COMPRESS_STEPS` error-feedback
    steps whose average holds to `repro`'s bound; ms a step and the bytes
    handed to the all-reduce."""
    zero = {k: torch.zeros_like(g) for k, g in grads.items()}
    differ = 0
    for k, g in grads.items():
        mean, res = grad_compression.compress_allreduce_mean(g, zero[k], group)
        cmean, cres = grad_compression.compress_allreduce_mean(g.cpu(), zero[k].cpu())
        differ += int(not torch.equal(mean.cpu(), cmean)) + int(not torch.equal(res.cpu(), cres))
        del mean, res, cmean, cres
    step = grad_compression.make_compressed_allreduce(group)
    res = grad_compression.init_residuals(grads)
    acc = {k: torch.zeros_like(g) for k, g in grads.items()}
    ms = []
    for _ in range(COMPRESS_STEPS):
        (means, res), t = _timed(lambda: step(grads, res))
        ms.append(t)
        for k in acc:
            acc[k] += means[k]
    worst = 0.0  # the largest |average - g| over its bound, of any element
    for k, g in grads.items():
        bound = COMPRESS_TOL * (g.abs() + g.abs().max())
        worst = max(worst, float(((acc[k] / COMPRESS_STEPS - g).abs() / bound).max()))
    rec = {"phase": "distributed", "part": "grad_compression", "leaves": sorted(grads),
           "elements": sum(g.numel() for g in grads.values()),
           "allreduce_bytes_a_step": sum(grad_compression.allreduce_bytes(g)
                                         for g in grads.values()),
           "card_vs_cpu_leaves_differing": differ, "steps": COMPRESS_STEPS,
           "step_ms_median": float(np.median(ms)), "step_ms": ms,
           "average_error_over_bound": worst}
    emit(rec)
    if differ:
        raise AssertionError(f"compressed mean on the card is not the CPU's: {rec}")
    if not worst <= 1.0:
        raise AssertionError(f"error feedback's average left repro's bound: {rec}")
    return rec


def _restore_as_dtensors(mesh, root: Path) -> dict:
    """olmoe_1b_7b's MoE layer saved, then restored under its
    `param_pspecs` (LM_RULES adapted to the mesh): every leaf a DTensor
    whose local tensor has the saved bits."""
    from torch.distributed.tensor import DTensor

    gen = torch.Generator(device="cuda").manual_seed(1)
    _, defs, params = _moe_layer("olmoe_1b_7b", gen)
    specs = param_pspecs(defs, adapt_rules(LM_RULES, mesh))
    (_, save_ms) = _timed(lambda: checkpoint.save(root, 1, params))
    restored, restore_ms = _timed(lambda: checkpoint.restore(root, 1, params, shardings=specs,
                                                             mesh=mesh))
    differ = [k for k in params if not isinstance(restored[k], DTensor)
              or not torch.equal(restored[k].to_local(), params[k])]
    rec = {"phase": "distributed", "part": "restore", "arch": "olmoe_1b_7b",
           "specs": {k: list(v) for k, v in specs.items()},
           "placements": {k: [str(p) for p in restored[k].placements] for k in restored},
           "bytes": sum(t.numel() * t.element_size() for t in params.values()),
           "save_ms": save_ms, "restore_ms": restore_ms, "leaves_differing": differ}
    emit(rec)
    if differ:
        raise AssertionError(f"restored leaves not DTensors of the saved bits: {differ}")
    del params, restored
    torch.cuda.empty_cache()
    return rec


def phase_distributed() -> dict:
    """Phase 18: the distributed layer on one card through a real NCCL
    communicator at world size 1 (the default process group from a
    FileStore, the (1, 1) test mesh). It never falls back to gloo. Returns
    the kernels' launches (none)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1),
                            rank=0, world_size=1)
    serve.reset_launch_counts()
    try:
        mesh = make_test_mesh("cuda")
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the process group runs {dist.get_backend()}, not nccl")
        grads = _ep_moe("olmoe_1b_7b", mesh)
        _ep_moe("llama4_maverick_400b_a17b", mesh)
        _compression(grads, dist.group.WORLD)
        del grads
        torch.cuda.empty_cache()
        _restore_as_dtensors(mesh, root / "ckpt")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    launches = serve.launch_counts()
    emit({"phase": "distributed", "part": "done", "backend": "nccl", "world_size": 1,
          "launches": launches, "seconds": time.perf_counter() - t0})
    if any(launches.values()):
        raise AssertionError(f"the distributed phase launched kernels: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the recommender's cells through a mesh, and ranks on one card
# ---------------------------------------------------------------------------

REC_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand", "train_batch")
# A cell fits the card where its peak `max_memory_allocated` is within
# REC_PEAK_BUDGET and its peak `max_memory_reserved` (the allocated bytes
# and the allocator's free blocks) within REC_RESERVED_BUDGET: the card's
# 85.0e9 bytes less room for the CUDA context, NCCL's buffers and what
# the earlier phases leave allocated (0.87 GB on an H100)
REC_PEAK_BUDGET = 76e9
REC_RESERVED_BUDGET = 80e9
# (arch, shape) -> examples (retrieval: candidates) where the shape's own
# size does not fit: the largest multiple of 512 that does,
# found on an H100 by `python3 chip_smoke.py --size-cells` (PERF.md §4
# lists its probes); every other cell runs at its shape's size
REC_CUTS = {
    ("taobao_ssa", "serve_bulk"): 79872,
    ("taobao_ssa", "train_batch"): 41984,
    ("dien", "serve_bulk"): 179712,
    ("dien", "retrieval_cand"): 277504,
    ("dien", "train_batch"): 51200,
    ("din", "retrieval_cand"): 397312,
    ("autoint", "retrieval_cand"): 635392,
}
REC_REPS = 3  # timed calls a cell past serve_p99 (which takes SERVE_REPS)
RANK_WORLDS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
RANK_ARCHS = ("taobao_ssa", "fm")
RANK_STEP_BATCH = 512
RANK_LR = 1e-4  # the cells' AdamW (`get_optimizer("adamw")`)
RANK_REPS = 3  # timed calls of a rank's case after the first
RANK_TIMEOUT_S = 420


def _sized(shape, n: int):
    """`shape` at `n` examples (a retrieval shape: `n` candidates)."""
    if shape.kind == "retrieval":
        return dataclasses.replace(shape, n_candidates=n)
    return dataclasses.replace(shape, batch=n)


def _rec_batch(cfg, meta: dict, gen, device) -> dict:
    """Real inputs for a recsys cell's "meta" batch: ids in each field's
    vocabulary, histories of 1..seq_len, labels 0/1."""
    vocab = {f.name: f.vocab for f in cfg.fields}
    field = {"hist_item": "item", "hist_category": "category", "cand_category": "category"}
    out = {}
    for k, a in meta.items():
        if k == "sparse_idx":
            out[k] = torch.stack([torch.randint(0, f.vocab, a.shape[:1], generator=gen,
                                                device=device, dtype=torch.int32)
                                  for f in cfg.fields], 1)
        elif k == "hist_len":
            out[k] = torch.randint(1, cfg.seq_len + 1, a.shape, generator=gen, device=device,
                                   dtype=torch.int32)
        elif k == "label":
            out[k] = torch.randint(0, 2, a.shape, generator=gen, device=device).float()
        else:
            out[k] = torch.randint(0, vocab[field.get(k, k)], a.shape, generator=gen,
                                   device=device, dtype=torch.int32)
    return out


def _rec_args(cfg, cell, gen, device="cuda") -> tuple:
    """Whole arguments for a recsys cell: params from `gen`, AdamW's first
    state, a batch (or a query and candidate ids) from `gen`."""
    params = init_params(api.param_defs(cfg), gen, device)
    kind = cell.meta["kind"]
    if kind == "train":
        return params, adamw(RANK_LR).init(params), _rec_batch(cfg, cell.args[2], gen, device)
    if kind == "serve":
        return params, _rec_batch(cfg, cell.args[1], gen, device)
    if cfg.interaction in ("fm", "self_attn"):
        top = max(f.vocab for f in cfg.fields)
    else:
        top = {f.name: f.vocab for f in cfg.fields}["item"]
    cand = torch.randint(0, top, cell.args[2].shape, generator=gen, device=device,
                         dtype=torch.int32)
    return params, _rec_batch(cfg, cell.args[1], gen, device), cand


def _rec_plain(cfg, kind):
    """The one-rank call a cell's `fn` is held against: no rules."""
    if kind == "serve":
        return lambda p, b: api.serve(p, b, cfg)
    if kind == "retrieval":
        return lambda p, q, c: api.retrieval(p, q, c, cfg)
    return make_train_step(lambda p, b: api.loss(p, b, cfg), adamw(RANK_LR))


def _tree_list(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _tree_list(t)]
    if isinstance(tree, dict):
        return [leaf for _, leaf in tree_leaves(tree)]
    return [tree]


def _differing(a, b) -> int:
    la, lb = _tree_list(a), _tree_list(b)
    if len(la) != len(lb):
        raise AssertionError(f"outputs of {len(la)} and {len(lb)} leaves")
    return sum(x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)
               for x, y in zip(la, lb))


def _rec_run(arch, cfg, shape_name, shape, mesh, gen) -> dict:
    """One cell at `shape` on `mesh`: its `fn` and the plain call on the same
    inputs (the `fn`'s output moved to the host while the plain call runs),
    the outputs' differing leaves, the launches of one `fn` call, the peak
    bytes of the two calls."""
    cell = cells.build_cell(arch, shape_name, mesh, shape=shape)
    args = _rec_args(cfg, cell, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    out = _to_cpu(cell.fn(*args))
    torch.cuda.synchronize()
    launches = serve.launch_counts()
    ref = _to_cpu(_rec_plain(cfg, cell.meta["kind"])(*args))
    torch.cuda.synchronize()
    return {"cell": cell, "args": args, "differing": _differing(out, ref),
            "launches_per_call": launches, "peak_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.max_memory_reserved()}


def _rec_size(arch, shape_name, mesh) -> dict:
    """The largest multiple of 512 up to the shape's own size at which the
    cell fits, and the probes [n, peak allocated bytes, peak reserved
    bytes] (None, None where the card ran out of memory): the whole size
    first, then from an eighth of it up, each next size the secant's of
    the larger of the two peaks' shares of their budgets through the two
    largest sizes that fit, where it falls between them and the smallest
    that does not, else the midpoint."""
    import gc

    cfg = get_config(arch)
    full = RECSYS_SHAPES[shape_name]
    n_full = full.n_candidates if full.kind == "retrieval" else full.batch
    probes, share = [], {}

    def fits(n):
        try:
            run = _rec_run(arch, cfg, shape_name, _sized(full, n), mesh,
                           torch.Generator(device="cuda").manual_seed(19))
            peaks = [run["peak_bytes"], run["reserved_bytes"]]
            del run
        except RuntimeError as e:  # torch.OutOfMemoryError, or cuBLAS's workspace
            if not ("out of memory" in str(e) or "ALLOC_FAILED" in str(e)):
                raise
            peaks = [None, None]
        gc.collect()
        torch.cuda.empty_cache()
        probes.append([n, *peaks])
        if peaks[0] is None:
            return False
        share[n] = max(peaks[0] / REC_PEAK_BUDGET, peaks[1] / REC_RESERVED_BUDGET)
        return share[n] <= 1.0

    lo, hi = n_full // 8 // 512 * 512, n_full
    if fits(hi):
        lo = hi
    else:
        if not fits(lo):
            raise AssertionError(f"{arch}:{shape_name} does not fit at {lo}")
        while hi - lo > 512:
            n = (lo + hi) // 2 // 512 * 512
            held = sorted((m, r) for m, r in share.items() if r <= 1.0)
            if len(held) > 1 and held[-1][1] > held[-2][1]:
                (n1, r1), (n2, r2) = held[-2:]
                guess = int(n2 + (1.0 - r2) * (n2 - n1) / (r2 - r1)) // 512 * 512
                if lo < guess < hi:
                    n = guess
                elif guess <= lo:
                    n = lo + 512
            if fits(n):
                lo = n
            else:
                hi = n
    rec = {"phase": "size_cells", "arch": arch, "shape": shape_name, "full": n_full,
           "fits": lo, "probes": probes}
    emit(rec)
    return rec


def size_cells() -> None:
    """`python3 chip_smoke.py --size-cells`: `_rec_size` of every recsys
    cell past serve_p99 on the one-rank NCCL mesh phase 19 uses; prints
    REC_CUTS's entries."""
    import torch.distributed as dist

    phase_device()
    phase_build()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sizes_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh("cuda")
        cuts = {}
        for arch in RECSYS_ARCHS:
            for shape_name in REC_SHAPES[1:]:
                rec = _rec_size(arch, shape_name, mesh)
                if rec["fits"] < rec["full"]:
                    cuts[f"{arch}:{shape_name}"] = rec["fits"]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "size_cells", "budget_bytes": REC_PEAK_BUDGET,
          "reserved_budget_bytes": REC_RESERVED_BUDGET,
          "card_bytes": torch.cuda.mem_get_info()[1], "cuts": cuts})


def _rec_cell_on_mesh(arch, shape_name, mesh) -> dict:
    """Phase 19's record of one (arch, shape) cell on the one-rank mesh, at
    its shape's size or REC_CUTS's. The plain call runs once, for the bits:
    at one rank the cell's `fn` is the plain path, so only `fn` is timed."""
    cfg = get_config(arch)
    full = RECSYS_SHAPES[shape_name]
    n_full = full.n_candidates if full.kind == "retrieval" else full.batch
    n = REC_CUTS.get((arch, shape_name), n_full)
    gen = torch.Generator(device="cuda").manual_seed(19)
    t0 = time.perf_counter()
    run = _rec_run(arch, cfg, shape_name, _sized(full, n), mesh, gen)
    cell, args = run["cell"], run["args"]
    torch.cuda.empty_cache()  # as `--size-cells` left the allocator after the two calls
    ms = [_timed(lambda: cell.fn(*args))[1]
          for _ in range(SERVE_REPS if shape_name == "serve_p99" else REC_REPS)]
    rec = {"phase": "recsys_cells", "arch": arch, "shape": shape_name,
           "examples": cell.meta["examples"], "cut": n < n_full, "full": n_full,
           "differing_leaves": run["differing"], "launches_per_call": run["launches_per_call"],
           "ms": float(np.median(ms)), "ms_each": ms, "peak_gb": run["peak_bytes"] / 1e9,
           "reserved_gb": run["reserved_bytes"] / 1e9,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    del run, args, cell
    torch.cuda.empty_cache()
    if rec["differing_leaves"]:
        raise AssertionError(f"{arch}:{shape_name} through the mesh differs from the plain "
                             f"call in {rec['differing_leaves']} leaves")
    return rec


def _cut_block(tree, specs, mesh, coord):
    """This rank's blocks (`block_slices`) of a tree of whole card tensors."""
    if isinstance(tree, dict):
        return {k: _cut_block(v, specs[k], mesh, coord) for k, v in tree.items()}
    return tree[block_slices(tree.shape, specs, mesh, coord)].contiguous()


def _spec_tree(tree, specs):
    """`specs` stretched over `tree`: a rep dict ({"w","mask"}, a
    "block_mask") where `specs` has one spec gives each of its leaves that
    spec, as `repro`'s layout of a pruned linear keeps its weight's."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v, specs[k] if isinstance(specs, dict) else specs)
                for k, v in tree.items()}
    return specs


def _rank_cases(mesh) -> list:
    """On this rank of `mesh` (gloo groups, every tensor on cuda:0):
    taobao_ssa's and FM's serve_p99, retrieval_cand and an AdamW step at
    `RANK_STEP_BATCH`, full width, each on this rank's blocks, and
    taobao_ssa's serve_p99 under the C2 window (`local_attention`) and with
    a tower pruned in 128-tiles (`block_pruned_matmul`). The forward
    against the one-rank call on the whole tables and this rank's blocks
    of the rest (to the bit) and against the one-rank call's block of the
    whole batch; the step against the one-rank step's block under phase
    5's rule."""
    from repro_torch.configs.shapes import RecSysShape
    from repro_torch.distributed import collectives

    coord = tuple(mesh.get_coordinate())
    step = RecSysShape("train_batch", RANK_STEP_BATCH, "train")
    cases = [(arch, shape_name, shape, "") for arch in RANK_ARCHS
             for shape_name, shape in (("serve_p99", None), ("retrieval_cand", None),
                                       ("train_batch", step))]
    cases += [("taobao_ssa", "serve_p99", None, "c2"), ("taobao_ssa", "serve_p99", None, "pruned")]
    out = []
    for arch, shape_name, shape, variant in cases:
        cfg = get_config(arch)
        if variant == "c2":
            cfg = with_attn_window(cfg, C2_WINDOW)
        gen = torch.Generator(device="cuda").manual_seed(23)  # the same on every rank
        torch.cuda.reset_peak_memory_stats()
        cell = cells.build_cell(arch, shape_name, mesh, cfg=cfg, shape=shape)
        whole = _rec_args(cfg, cell, gen)
        specs = cell.in_specs
        if variant == "pruned":
            whole = (pruning.with_block_masks(pruning.prune_tree(whole[0], 0.5, structured=True)),
                     *whole[1:])
            specs = (_spec_tree(whole[0], specs[0]), *specs[1:])
        blocks = [_cut_block(a, s, mesh, coord) for a, s in zip(whole, specs)]
        serve.reset_launch_counts()
        got, first_ms = _timed(lambda: cell.fn(*blocks))
        launches = serve.launch_counts()
        ms = float(np.median([_timed(lambda: cell.fn(*blocks))[1] for _ in range(RANK_REPS)]))
        rec = {"mesh": list(mesh.shape), "coord": coord, "arch": arch, "shape": shape_name,
               "variant": variant, "launches": launches, "first_ms": first_ms, "ms": ms,
               "through_host": collectives.through_host(
                   got if torch.is_tensor(got) else got[2]["loss"], mesh.get_group("model"))}
        kind = cell.meta["kind"]
        plain = _rec_plain(cfg, kind)
        if kind != "train":
            own = plain(whole[0], *blocks[1:])
            ref = _cut_block(plain(*whole), cell.out_specs, mesh, coord)
            rec.update(own_block_same_bits=bool(torch.equal(own, got)),
                       vs_whole_max_abs=float((ref - got).abs().max()))
            rec["ok"] = rec["own_block_same_bits"]
        else:
            # the whole tree's steps below run on every rank at once: this
            # rank's blocks and step go to the host first
            loss, gnorm = float(got[2]["loss"]), float(got[2]["grad_norm"])
            after = _to_cpu(got[0])
            blocks = got = None
            before = _to_cpu(_cut_block(whole[0], specs[0], mesh, coord))
            sgd_step = make_train_step(lambda p, b: api.loss(p, b, cfg), sgd(1.0, momentum=0.0))
            clipped = _to_cpu(_cut_block(sgd_step(whole[0], sgd(1.0, momentum=0.0).init(whole[0]),
                                                  whole[2])[0], specs[0], mesh, coord))
            grads = {path: b - a for (path, b), (_, a)
                     in zip(tree_leaves(before), tree_leaves(clipped))}
            floor = TRAIN_ZERO_GRAD_REL * max(float(g.abs().max()) for g in grads.values())
            zero = {p for p, g in grads.items() if float(g.abs().max()) <= floor}
            one, _, one_m = plain(*whole)
            host = _to_cpu(_cut_block(one, specs[0], mesh, coord))
            del one
            worst, rows = _compare_step(f"{arch}@{mesh.shape}", before, after, host, grads, zero,
                                        RANK_LR)
            rec.update(max_abs_diff=worst, loss=loss, loss_one_rank=float(one_m["loss"]),
                       grad_norm=gnorm, grad_norm_one_rank=float(one_m["grad_norm"]),
                       bad_leaves=[r["leaf"] for r in rows if not r["ok"]])
            rec["ok"] = (not rec["bad_leaves"]
                         and abs(loss - rec["loss_one_rank"]) <= LOSS_REL * abs(loss)
                         and abs(gnorm - rec["grad_norm_one_rank"]) <= GRAD_NORM_REL * gnorm)
        kernel = {"c2": "local_attention", "pruned": "block_pruned_matmul"}.get(variant)
        if kernel and not launches[kernel]:
            rec["ok"] = False
            rec["missing_kernel"] = kernel
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out.append(rec)
        del whole, blocks, got
        torch.cuda.empty_cache()
    return out


def _ranks_main(rank, world, init_file, meshes, out_dir) -> None:
    """A process of phase 19's ranks: a gloo group of `world` on one card."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_names, make_mesh

    torch.cuda.set_device(0)
    serve.disable_tf32()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        recs = [r for shape in meshes
                for r in _rank_cases(make_mesh(shape, axis_names(shape), "cpu"))]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(recs, Path(out_dir) / f"rank{rank}.pt")


def _ranks_on_one_card(world: int, meshes) -> list:
    import torch.multiprocessing as mp

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "recsys_ranks", "world": world, "card_free_gb": free / 1e9,
          "card_gb": total / 1e9, "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9})
    ctx = mp.start_processes(_ranks_main, args=(world, str(root / "init"), meshes, str(root)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > RANK_TIMEOUT_S:
                raise TimeoutError(f"{world} ranks ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    recs = [r for rank in range(world) for r in torch.load(root / f"rank{rank}.pt",
                                                              weights_only=False)]
    shutil.rmtree(root, ignore_errors=True)
    for r in recs:
        emit({"phase": "recsys_ranks", "world": world, **r})
    emit({"phase": "recsys_ranks", "world": world, "seconds": time.perf_counter() - t0})
    bad = [(r["mesh"], r["coord"], r["arch"], r["shape"], r["variant"])
           for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"ranks on one card differ from one rank: {bad}")
    if not all(r["launches"]["embedding_bag"] for r in recs):
        raise AssertionError("a rank's call launched no embedding_bag")
    return recs


def phase_recsys_cells() -> dict:
    """Phase 19: ranks that split the tables on the one card
    (`_ranks_on_one_card`), first, while this process holds little of the
    card; then the five recsys archs' cells (`launch/cells.build_cell`)
    at the dry run's shapes through a one-rank NCCL mesh, each against the
    plain call (the bits, ms, peak GB, launches a call), at `REC_CUTS`'s
    size where the shape's own does not fit. Returns the launches of the
    one-rank part, counted from 0."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for world, meshes in RANK_WORLDS.items():
        _ranks_on_one_card(world, meshes)
    torch.cuda.empty_cache()
    emit({"phase": "recsys_cells", "part": "start",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cells_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1),
                            rank=0, world_size=1)
    totals = {k: 0 for k in serve.KERNELS}
    try:
        mesh = make_test_mesh("cuda")
        for arch in RECSYS_ARCHS:
            for shape_name in REC_SHAPES:
                serve.reset_launch_counts()
                _rec_cell_on_mesh(arch, shape_name, mesh)
                totals = {k: totals[k] + n for k, n in serve.launch_counts().items()}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "recsys_cells", "part": "done", "launches": totals,
          "seconds": time.perf_counter() - t0})
    return totals


# phase 20: the LM trunk across ranks on one card: yi_6b and olmoe_1b_7b at
# full width cut to 2 layers, bf16, weights from seed 20, over gloo ranks
# sharing the card (every tensor on cuda:0, each exchange through host
# memory), each rank's blocks against the one-rank call on the same card.
# olmoe's capacity factor is raised so that no entry drops on any mesh:
# its dispatch then routes each token alike on every mesh, and the
# cross-entropy's gradients are the mesh's to compare (the aux loss is the
# mean of each rank's own, as `repro`'s, and its gradient depends on the
# mesh: the CPU tests hold it against `repro` on the same mesh)
LM_RANK_ARCHS = ("yi_6b", "olmoe_1b_7b")
LM_RANK_WORLDS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
LM_RANK_LAYERS, LM_RANK_SEED, LM_RANK_CAPACITY = 2, 20, 4.0
LM_RANK_TRAIN = (4, 1024)  # the AdamW step's batch x tokens
LM_RANK_PREFILL = (4, 2048)
LM_RANK_DECODE = (4, 4096, 8)  # batch, cache positions (a prefill's), steps
LM_RANK_DECODE_POS = (100, 1500, 2047, 4000)  # each row's first position
LM_RANK_LONG = (16384, 4, 9000)  # batch 1: cache positions, steps, first position
# against the one-rank call, of the largest |value| of the one-rank output:
# the bf16 tolerances the port holds against jitted `repro` (ROADMAP Queue
# 3): logits and caches 3e-2, each gradient leaf 4e-2, the loss 1e-3. An
# MoE arch's bf16 decode is recorded, not held: its router's bf16 logits
# tie and near-tie, so the split path's other rounding of the attention
# before it flips top-8 choices (olmoe's decode logits 0.44 apart at (1, 2)
# on an H100, its prefill the one-rank bits); the same weights
# in f32 (TF32 off) hold its decode at `LM_RANK_F32_TOL`
LM_RANK_LOGITS_TOL, LM_RANK_GRAD_TOL, LM_RANK_LOSS_TOL = 3e-2, 4e-2, 1e-3
LM_RANK_F32_TOL = 1e-4
LM_RANK_TIMEOUT_S = 600


def _lm_rank_cfg(arch: str):
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_RANK_LAYERS)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=LM_RANK_CAPACITY)
    return cfg


def _lm_rank_inputs(cfg) -> dict:
    """Phase 20's token ids, numpy, the same in every process."""
    rng = np.random.default_rng(LM_RANK_SEED)
    (B, S), (Bp, Sp), (Bd, Td, nd), (Tl, nl, _) = (LM_RANK_TRAIN, LM_RANK_PREFILL,
                                                   LM_RANK_DECODE, LM_RANK_LONG)
    batch = next(synthetic.lm_token_batches(cfg.vocab_size, B, S, 1, seed=LM_RANK_SEED))
    return {"batch": batch, "prefill": rng.integers(0, cfg.vocab_size, (Bp, Sp)).astype(np.int32),
            "decode_fill": rng.integers(0, cfg.vocab_size, (Bd, Td)).astype(np.int32),
            "decode": rng.integers(0, cfg.vocab_size, (nd, Bd)).astype(np.int32),
            "long_fill": rng.integers(0, cfg.vocab_size, (1, Tl)).astype(np.int32),
            "long": rng.integers(0, cfg.vocab_size, (nl, 1)).astype(np.int32)}


def _lm_rank_params(cfg):
    return init_params(transformer.param_defs(cfg),
                       torch.Generator(device="cuda").manual_seed(LM_RANK_SEED), "cuda")


def _ce_loss(cfg, rules=None):
    """The cross entropy alone as a loss (`value_and_grad`'s form)."""
    def fn(p, b):
        _, metrics = transformer.loss(p, b, cfg, rules)
        return metrics["ce"], metrics
    return fn


def _lm_decode_run(fn, params, cache, tokens, pos):
    """`fn` stepped once a row of `tokens`, from `pos`: (the logits of each
    step, the ms of each, the last cache)."""
    logits, ms = [], []
    for t in range(tokens.shape[0]):
        (lg, cache), dt = _timed(lambda: fn(params, cache, tokens[t], pos + t))
        logits.append(lg)
        ms.append(dt)
    return logits, ms, cache


def _lm_rank_reference(arch: str, root: Path) -> dict:
    """Phase 20's one-rank calls of `arch` on the card (no mesh), saved to
    `root` on the host for the ranks: the cross entropy's gradients and
    the AdamW step's metrics, the prefill's logits and caches, the decode
    and long-context decode steps from prefilled caches."""
    cfg = _lm_rank_cfg(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _lm_rank_params(cfg)
    ins = {k: (torch.from_numpy(v).cuda() if not isinstance(v, dict)
               else {n: torch.from_numpy(x).cuda() for n, x in v.items()})
           for k, v in _lm_rank_inputs(cfg).items()}
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.training.train_loop import value_and_grad

    ref, ms = {}, {}
    (ce, metrics, grads), ms["grad"] = _timed(lambda: value_and_grad(_ce_loss(cfg), params,
                                                                      ins["batch"]))
    ref["grads"] = _to_cpu(grads)
    ref["grad_max"] = {"/".join(p): float(g.abs().max()) for p, g in tree_leaves(grads)}
    del grads
    opt = get_optimizer("adamw")
    step = make_train_step(lambda p, b: transformer.loss(p, b, cfg), opt)
    (_, _, m), ms["step"] = _timed(lambda: step(params, opt.init(params), ins["batch"]))
    ref["metrics"] = {k: float(v) for k, v in m.items()}
    del m
    torch.cuda.empty_cache()
    with torch.no_grad():
        (logits, kv), ms["prefill"] = _timed(lambda: transformer.prefill(params, ins["prefill"],
                                                                         cfg))
        ref["prefill"] = _to_cpu((logits, kv))
        del logits, kv
        for kind, dtype in _lm_decode_kinds(cfg):
            base = kind.split("_")[0]
            c, p = _as_dtype(cfg, params, dtype)
            if base == "long":
                c = dataclasses.replace(c, sparse_attention=True)
            if f"{base}_fill" not in ref:  # the caches: a prefill of the whole cache, bf16
                _, fill = transformer.prefill(params, ins[f"{base}_fill"], cfg)
                ref[f"{base}_fill"] = _to_cpu(fill)
                del fill
            fill = _fill_as(ref[f"{base}_fill"], dtype, "cuda")
            first = LM_RANK_DECODE_POS if base == "decode" else (LM_RANK_LONG[2],)
            pos = torch.tensor(first, dtype=torch.int64, device="cuda")
            logits, t, cache = _lm_decode_run(
                lambda pp, cc, tok, q: transformer.decode(pp, cc, tok, q, c), p, fill, ins[base],
                pos)
            ms[kind] = float(np.median(t[1:]))
            ref[kind] = _to_cpu((torch.stack(logits), cache))
            del fill, logits, cache, p
            torch.cuda.empty_cache()
    ref["ms"] = ms
    ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(ref, root / f"{arch}.pt")
    del params, ins
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gb": ref["peak_gb"], "metrics": ref["metrics"]}


def _lm_decode_kinds(cfg):
    """Phase 20's decode runs: (name, dtype): bf16 always, f32 as well for
    an MoE arch (see `LM_RANK_F32_TOL`)."""
    kinds = [("decode", cfg.dtype), ("long", cfg.dtype)]
    if cfg.n_experts:
        kinds += [("decode_f32", "float32"), ("long_f32", "float32")]
    return kinds


def _fill_as(fill, dtype: str, device):
    """A prefilled bf16 cache pair in `dtype` on `device` (the f32 runs
    decode from the same cache, its values cast)."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    return tuple(x.to(device=device, dtype=dt) for x in fill)


def _as_dtype(cfg, params, dtype: str):
    """(cfg, params) in `dtype`: the same weights, cast."""
    if dtype == cfg.dtype:
        return cfg, params
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    return dataclasses.replace(cfg, dtype=dtype), tree_map(lambda t: t.to(dt), params)


def _rel_block(got, ref_whole, spec, mesh, coord, scale=None) -> float:
    """max |got - its block of ref_whole| over the largest |ref_whole|."""
    blk = ref_whole[block_slices(ref_whole.shape, spec, mesh, coord)].to(got.device)
    scale = float(ref_whole.abs().max()) if scale is None else scale
    return float((got.float() - blk.float()).abs().max()) / max(scale, 1e-30)


def _lm_rank_cases(arch: str, mesh, root: Path) -> list:
    """On this rank of `mesh`: `arch`'s train, prefill, decode and
    long-context decode cells (`launch/cells.build_cell`) on this rank's
    blocks, each against the one-rank call's block (`_lm_rank_reference`)."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.training.train_loop import value_and_grad

    cfg = _lm_rank_cfg(arch)
    ref = torch.load(root / f"{arch}.pt", mmap=True, weights_only=True)
    coord = tuple(mesh.get_coordinate())
    whole = _lm_rank_params(cfg)
    ins = _lm_rank_inputs(cfg)
    rules = adapt_rules(LM_RULES, mesh)
    (B, S), (Bp, Sp), (Bd, Td, _), (Tl, _, long_pos) = (LM_RANK_TRAIN, LM_RANK_PREFILL,
                                                        LM_RANK_DECODE, LM_RANK_LONG)
    shapes = {"train": ("train_4k", LMShape("train_4k", S, B, "train")),
              "prefill": ("prefill_32k", LMShape("prefill_32k", Sp, Bp, "prefill")),
              "decode": ("decode_32k", LMShape("decode_32k", Td, Bd, "decode")),
              "long": ("long_500k", LMShape("long_500k", Tl, 1, "decode"))}
    built = {k: cells.build_cell(arch, n, mesh, cfg=cfg, shape=sh)
             for k, (n, sh) in shapes.items() if k in ("train", "prefill")}
    blocks = {k: _cut_block(whole, built[k].in_specs[0], mesh, coord) for k in ("train", "prefill")}
    del whole
    torch.cuda.empty_cache()
    cut = lambda a, spec: _cut_block(torch.as_tensor(a).cuda(), spec, mesh, coord)  # noqa: E731
    base = {"mesh": list(mesh.shape), "coord": coord, "arch": arch, "n_layers": cfg.n_layers,
            "dtype": cfg.dtype}
    out = []

    # the train cell: the cross entropy's gradients, then the AdamW step
    cell = built["train"]
    params = blocks.pop("train")
    batch = {k: cut(v, cell.in_specs[2][k]) for k, v in ins["batch"].items()}
    torch.cuda.reset_peak_memory_stats()
    (ce, _, grads), grad_ms = _timed(lambda: value_and_grad(_ce_loss(cfg, rules), params, batch))
    errs = {"/".join(p): _rel_block(g, _leaf(ref["grads"], p), _leaf(cell.in_specs[0], p), mesh,
                                    coord, ref["grad_max"]["/".join(p)])
            for p, g in tree_leaves(grads)}
    del grads
    opt = get_optimizer("adamw")
    (_, _, m), step_ms = _timed(lambda: cell.fn(params, opt.init(params), batch))
    metrics = {k: float(v) for k, v in m.items()}
    one = ref["metrics"]
    rec = {**base, "kind": "train", "tokens": [B, S], "step_ms": step_ms, "grad_ms": grad_ms,
           "one_rank_step_ms": ref["ms"]["step"], "one_rank_grad_ms": ref["ms"]["grad"],
           "metrics": metrics, "one_rank_metrics": one,
           "ce_rel_diff": abs(metrics["ce"] - one["ce"]) / abs(one["ce"]),
           "grad_rel_diff_max": max(errs.values()), "grad_leaf_worst": max(errs, key=errs.get),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec["ok"] = rec["ce_rel_diff"] <= LM_RANK_LOSS_TOL and rec["grad_rel_diff_max"] <= \
        LM_RANK_GRAD_TOL
    if not cfg.n_experts:  # the loss is the cross entropy: the step's whole metrics
        for k in ("loss", "grad_norm"):
            rec[f"{k}_rel_diff"] = abs(metrics[k] - one[k]) / abs(one[k])
            rec["ok"] = rec["ok"] and rec[f"{k}_rel_diff"] <= LM_RANK_LOSS_TOL
    out.append(rec)
    del params, batch, m
    torch.cuda.empty_cache()

    # prefill, then the decode cells from prefilled caches
    params = blocks.pop("prefill")
    with torch.no_grad():
        cell = built["prefill"]
        torch.cuda.reset_peak_memory_stats()
        (logits, (k, v)), ms = _timed(lambda: cell.fn(params, cut(ins["prefill"],
                                                                   cell.in_specs[1])))
        lspec, (cspec, _) = cell.out_specs
        diffs = {"logits": _rel_block(logits, ref["prefill"][0], lspec, mesh, coord),
                 "k": _rel_block(k, ref["prefill"][1][0], cspec, mesh, coord),
                 "v": _rel_block(v, ref["prefill"][1][1], cspec, mesh, coord)}
        out.append({**base, "kind": "prefill", "tokens": [Bp, Sp], "ms": ms,
                    "one_rank_ms": ref["ms"]["prefill"], "rel_diffs": diffs,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "ok": max(diffs.values()) <= LM_RANK_LOGITS_TOL})
        del logits, k, v
        for kind, dtype in _lm_decode_kinds(cfg):
            base_kind = kind.split("_")[0]
            c, p = _as_dtype(cfg, params, dtype)
            cell = cells.build_cell(arch, shapes[base_kind][0], mesh, cfg=c,
                                    shape=shapes[base_kind][1])
            _, (cspec, _), tspec, pspec_ = cell.in_specs
            fill = _fill_as([_cut_block(x, cspec, mesh, coord) for x in ref[f"{base_kind}_fill"]],
                            dtype, "cuda")
            first = (long_pos,) if base_kind == "long" else LM_RANK_DECODE_POS
            pos = cut(np.array(first, np.int64), pspec_)
            tokens = cut(ins[base_kind], P(None, *tspec))
            torch.cuda.reset_peak_memory_stats()
            logits, ms, cache = _lm_decode_run(cell.fn, p, fill, tokens, pos)
            lspec = P(None, *cell.out_specs[0])
            diffs = {"logits": _rel_block(torch.stack(logits), ref[kind][0], lspec, mesh, coord),
                     "k": _rel_block(cache[0], ref[kind][1][0], cspec, mesh, coord),
                     "v": _rel_block(cache[1], ref[kind][1][1], cspec, mesh, coord)}
            held = dtype == "float32" or not cfg.n_experts
            tol = LM_RANK_F32_TOL if dtype == "float32" else LM_RANK_LOGITS_TOL
            out.append({**base, "kind": kind, "dtype": dtype,
                        "batch": 1 if base_kind == "long" else Bd,
                        "cache": Tl if base_kind == "long" else Td, "steps": len(ms),
                        "first_pos": list(first), "ms": float(np.median(ms[1:])), "ms_each": ms,
                        "one_rank_ms": ref["ms"][kind], "rel_diffs": diffs, "held": held,
                        "tol": tol, "finite": bool(all(torch.isfinite(x).all() for x in logits)),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            out[-1]["ok"] = out[-1]["finite"] and (not held or max(diffs.values()) <= tol)
            del fill, cache, logits, p
    del params, blocks, ref
    torch.cuda.empty_cache()
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _lm_ranks_main(rank, world, init_file, meshes, root, out_dir) -> None:
    """A process of phase 20's ranks: a gloo group of `world` on one card."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_names, make_mesh

    torch.cuda.set_device(0)
    serve.disable_tf32()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=LM_RANK_TIMEOUT_S))
    try:
        recs = [r for shape in meshes
                for mesh in [make_mesh(shape, axis_names(shape), "cpu")]
                for arch in LM_RANK_ARCHS for r in _lm_rank_cases(arch, mesh, Path(root))]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(recs, Path(out_dir) / f"rank{rank}.pt")


def phase_lm_ranks() -> dict:
    """Phase 20: the LM trunk across ranks on the one card. The one-rank
    calls first (`_lm_rank_reference`, saved to the host), then 2 and 4
    spawned processes (gloo groups over a mesh of device type "cpu", every
    tensor on cuda:0) as (1, 2), (2, 2) and (1, 4) meshes, each rank on its
    blocks of `launch/cells`' LM cells (`_lm_rank_cases`). Each rank's
    record: its ms, peak GB and largest difference from the one-rank call.
    Returns the launches of the parent's calls (none: the LM reaches no
    kernel)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_ranks_"))
    serve.reset_launch_counts()
    try:
        for arch in LM_RANK_ARCHS:
            emit({"phase": "lm_ranks", "part": "one_rank", "arch": arch,
                  **_lm_rank_reference(arch, root)})
        launches = serve.launch_counts()
        torch.cuda.empty_cache()
        for world, meshes in LM_RANK_WORLDS.items():
            t1 = time.perf_counter()
            ctx = mp.start_processes(_lm_ranks_main,
                                     args=(world, str(root / f"init{world}"), meshes, str(root),
                                           str(root)), nprocs=world, join=False,
                                     start_method="spawn")
            try:
                while not ctx.join(timeout=1.0):
                    if time.perf_counter() - t1 > LM_RANK_TIMEOUT_S:
                        raise TimeoutError(f"{world} ranks ran past {LM_RANK_TIMEOUT_S} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join(5)
            recs = [r for rank in range(world)
                    for r in torch.load(root / f"rank{rank}.pt", weights_only=False)]
            for r in recs:
                emit({"phase": "lm_ranks", "world": world, **r})
            emit({"phase": "lm_ranks", "world": world, "seconds": time.perf_counter() - t1})
            bad = [(r["mesh"], r["coord"], r["arch"], r["kind"]) for r in recs if not r["ok"]]
            if bad:
                raise AssertionError(f"LM ranks on one card differ from one rank: {bad}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "lm_ranks", "part": "done", "launches": launches,
          "cuts": {"n_layers": LM_RANK_LAYERS, "train_tokens": list(LM_RANK_TRAIN),
                   "prefill_tokens": list(LM_RANK_PREFILL), "decode": list(LM_RANK_DECODE),
                   "long": list(LM_RANK_LONG), "olmoe_capacity_factor": LM_RANK_CAPACITY},
          "seconds": time.perf_counter() - t0})
    if any(launches.values()):
        raise AssertionError(f"the LM path launched kernels: {launches}")
    return launches


# phase 21: the dry run (`launch/dryrun`): cells traced on fake tensors over
# a fake process group, counted by `launch/hlo_stats.Counter`; run right
# after the build, while the card holds nothing else
DRYRUN_CELLS = (("fm", "serve_p99"), ("yi_6b", "decode_32k"))  # (a): 16x16, cuda vs cpu
DRYRUN_REAL = ("dien", "train_batch")  # (b), (c): at REC_CUTS' size on one rank
# (c): the real call's `max_memory_allocated` over the dry run's `peak_bytes`
# must lie in this range: 1.0097 measured (78.67 GB over 77.91) on an NVIDIA
# H100 80GB HBM3 at 700 W, torch 2.11 (PERF.md §6)
DRYRUN_MEM_RATIO = (0.99, 1.03)
DRYRUN_TIMEOUT_S = 240
_DRYRUN_ONE_RANK = """
import dataclasses, json, sys
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.launch import dryrun
arch, shape_name, n, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
full = RECSYS_SHAPES[shape_name]
size = {"n_candidates": n} if full.kind == "retrieval" else {"batch": n}
rec = dryrun.run_on_mesh(arch, shape_name, (1, 1), "cuda", shape=dataclasses.replace(full, **size))
open(out, "w").write(json.dumps(rec))
"""


def _dryrun_runs(out_dir: Path, n: int) -> dict:
    """The dry runs of phase 21, each a process of its own (a fake process
    group is process-global), started together: `DRYRUN_CELLS` at 16x16 on
    fake cuda and cpu tensors through the command line, and `DRYRUN_REAL`
    at `n` examples on a fake (1, 1) mesh on fake cuda tensors. Returns the
    records."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmds = {(arch, shape, dev): [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                 arch, "--shape", shape, "--mesh", "single", "--device", dev,
                                 "--results", str(out_dir / dev)]
            for arch, shape in DRYRUN_CELLS for dev in ("cuda", "cpu")}
    cmds["one_rank"] = [sys.executable, "-c", _DRYRUN_ONE_RANK, *DRYRUN_REAL, str(n),
                        str(out_dir / "one_rank.json")]
    procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, c in cmds.items()}
    try:
        for k, p in procs.items():
            _, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"dry run {k} failed:\n{err[-4000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = {k: json.loads((out_dir / k[2] / f"{k[0]}__{k[1]}__single.json").read_text())
            for k in cmds if k != "one_rank"}
    recs["one_rank"] = json.loads((out_dir / "one_rank.json").read_text())
    return recs


def dryrun_real_step(n: int, out: str) -> None:
    """Phase 21 (b) and (c)'s real call, in a process of its own (so that
    its ~79 GB peak leaves no cached segment pinned in the parent):
    `DRYRUN_REAL` at `n` examples, weights and batch from seed 21, through a
    one-rank NCCL mesh under `hlo_stats.count`. Writes to `out` the stats,
    memory, launches, `max_memory_allocated` over the call (after
    `reset_peak_memory_stats`, the card holding the call's arguments only)
    and what was allocated before it."""
    import torch.distributed as dist

    serve.disable_tf32()
    arch, shape_name = DRYRUN_REAL
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_real_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(root / "store"), 1),
                            rank=0, world_size=1)
    try:
        cell = cells.build_cell(arch, shape_name, make_test_mesh("cuda"),
                                shape=_sized(RECSYS_SHAPES[shape_name], n))
        args = _rec_args(get_config(arch), cell, torch.Generator(device="cuda").manual_seed(21))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        serve.reset_launch_counts()
        _, stats, mem = hlo_stats.count(cell.fn, args, cell.donate)
        torch.cuda.synchronize()
        rec = {"stats": stats, "memory": mem, "launches": serve.launch_counts(),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "allocated_before": before}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    Path(out).write_text(json.dumps(rec))


def phase_dryrun() -> dict:
    """Phase 21: (a) `DRYRUN_CELLS` traced on fake cuda tensors give the
    record of fake cpu tensors, all but `device` and `timings`; (b)
    `DRYRUN_REAL` run for real on the card through a one-rank NCCL mesh
    under the same counter (`dryrun_real_step`) gives the dry run's dot
    flops, kernel calls and work and collectives on a fake (1, 1) mesh, and
    its launches equal the dry run's kernel calls; (c) the real call's
    `max_memory_allocated` over the dry run's `peak_bytes`, beside the
    card's name and power limit, within `DRYRUN_MEM_RATIO`. Every run is a
    process of its own; this one touches no card memory."""
    t0 = time.perf_counter()
    n = REC_CUTS[DRYRUN_REAL]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        recs = _dryrun_runs(root, n)
        t_dry = time.perf_counter() - t0
        same = {}
        for a, s in DRYRUN_CELLS:
            on = [{k: v for k, v in recs[(a, s, dev)].items() if k not in ("device", "timings")}
                  for dev in ("cuda", "cpu")]
            same[f"{a}:{s}"] = on[0] == on[1]
            emit({"phase": "dryrun", "part": "a", "cell": f"{a}:{s}", "mesh": on[0]["mesh"],
                  "same_record": same[f"{a}:{s}"], "flops": on[0]["flops"],
                  "bytes_accessed": on[0]["bytes_accessed"],
                  "collectives": on[0]["collectives"]["total"], "kernels": on[0]["kernels"],
                  "peak_bytes": on[0]["peak_bytes"],
                  "trace_s": {dev: recs[(a, s, dev)]["timings"]["trace_s"]
                              for dev in ("cuda", "cpu")}})
        dry = recs["one_rank"]
        cmd = [sys.executable, "-c", "import sys, chip_smoke as c; "
               "c.dryrun_real_step(int(sys.argv[1]), sys.argv[2])", str(n),
               str(root / "real.json")]
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"the real step failed:\n{proc.stderr[-4000:]}")
        real = json.loads((root / "real.json").read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats, mem, launches, peak = (real[k] for k in ("stats", "memory", "launches",
                                                     "max_memory_allocated"))
    calls = {k: v["calls"] for k, v in dry["kernels"].items()}
    checks = {"flops": stats["flops"] == dry["flops"],
              "kernels": stats["kernels"] == dry["kernels"],
              "collectives": stats["collectives"] == dry["collectives"],
              "launches": {k: v for k, v in launches.items() if v} == calls,
              "argument_bytes": mem["argument_bytes"] == dry["memory"]["argument_bytes"]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    ratio = peak / dry["peak_bytes"]
    rec = {"phase": "dryrun", "part": "b", "cell": dry["cell"], "examples": n,
           "checks": checks, "flops": stats["flops"], "dry_flops": dry["flops"],
           "kernels": stats["kernels"], "dry_kernels": dry["kernels"], "launches": launches,
           "collectives": stats["collectives"]["total"],
           "dry_collectives": dry["collectives"]["total"],
           "max_memory_allocated": peak, "allocated_before": real["allocated_before"],
           "dry_peak_bytes": dry["peak_bytes"], "dry_memory": dry["memory"],
           "counted_temp_bytes": mem["temp_bytes"], "memory_ratio": ratio,
           "memory_ratio_bound": list(DRYRUN_MEM_RATIO), "nvidia_smi": smi,
           "parent_reserved_bytes": torch.cuda.memory_reserved(),
           "dry_runs_s": t_dry, "seconds": time.perf_counter() - t0}
    emit(rec)
    print(f"dryrun memory: max_memory_allocated / peak_bytes = {ratio:.4f} on {smi}", flush=True)
    bad = [k for k, ok in {**same, **checks}.items() if not ok]
    if bad:
        raise AssertionError(f"the dry run disagrees: {bad}")
    if not DRYRUN_MEM_RATIO[0] <= ratio <= DRYRUN_MEM_RATIO[1]:
        raise AssertionError(f"memory ratio {ratio} outside {DRYRUN_MEM_RATIO}")
    return rec

def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_dryrun()
    kernels = phase_kernels()
    params, ladder_variants, train_launches = phase_ladder()
    phase_train_vs_cpu(params)
    del params

    # launches by main path: taobao_ssa's training (pretraining and the
    # ladder), then each arch's serve phase; each counted from 0
    by_path = {"train_taobao_ssa": train_launches}
    for arch in RECSYS_ARCHS:
        by_path[f"serve_{arch}"], by_path[f"calibrate_{arch}"] = drive_arch(
            arch, ladder_variants if arch == "taobao_ssa" else None)
        ladder_variants = None
    by_path["serve_taobao_ssa_c2"] = phase_serve_c2()
    by_path["bench_kernels"] = phase_bench()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        by_path.update(phase_train(Path(root)))
    by_path["compress_and_serve"] = phase_compress_and_serve()
    by_path["quickstart"] = phase_quickstart()
    for arch in LM_SERVE_ARCHS:
        by_path[f"lm_serve_{arch}"] = phase_lm_serve(arch)
    for name in GNN_RUN_SHAPES:
        by_path[f"gnn_{name}"] = phase_gnn_full_size(name)
    emit({"phase": "gnn_full_size", **_ogb_products_reckoning(get_config("nequip"))})
    by_path["distributed"] = phase_distributed()
    by_path["recsys_cells"] = phase_recsys_cells()
    by_path["lm_ranks"] = phase_lm_ranks()
    for path in ("train_launcher_fm", "train_launcher_dien"):
        if not (by_path[path]["fm_interaction"] or by_path[path]["augru"]):
            raise AssertionError(f"{path} launched neither fm_interaction nor augru")
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
    size_cells() if sys.argv[1:] == ["--size-cells"] else main()
