"""Serving launcher (the pipeline of `repro.launch.serve`): builds the
Table-I variants of one recsys arch at full width, times the serve call at
each batch size on the card, calibrates each variant's latency curve on
that call and serves it through the elastic engine under a traffic profile.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch taobao_ssa|fm|dien|din|autoint] \
        [--variants baseline,quantized,pruned,pruned_quantized,distilled] \
        [--train-steps 40] [--structured] --sizes 1,8,32,128,512 [--device cuda] \
        [--params params.npz] [--reps 20] [--profile steady|spike|ramp] [--horizon 60]

Prints one JSON line per variant and size: median and p90 ms of a serve
call, and each kernel's launches per call; then per variant `repro`'s line
of the engine's p50, p99 and throughput under `--profile` (`simulate`: the
curve `latency_model` calibrates, two replicas, autoscaling, a p99 SLO of
100 ms, `--horizon` simulated seconds); last one JSON object,
`{"serving": {variant: p50_ms, p99_ms, throughput, rejected, latency_1,
latency_512}, "stats": variant_stats}` (no "stats" without the ladder).
Parameters are random (`init_params` on the device, from seed 0) unless
`--params` names an .npz whose keys are the tree's paths joined by "/"
(e.g. "tables/item", "enc0/wq", "tower_w0").
taobao_ssa, the arch with a ladder, then always pretrains, as `repro`'s
launcher does, whichever variants are asked for: `--train-steps` steps of
AdamW at lr 1e-3 on batches of 256 (`launch/train.make_data`, seed 0), so
`baseline` names the same tree in every run. `quantized` is post-training
quantization of those parameters (`core/quantization.quantize_tree`). The
trained variants (`pruned`, `pruned_quantized`, `distilled`) come from
`run_ladder` with 10 fine-tune, 10 QAT and 15 distillation steps on the
batches of seed 1; `--structured` prunes in 128 x 128 tiles, whose linears
then run the block-pruned kernel. A taobao_ssa config that carries the
paper's C2 local-attention window (|i−j| < W), as
`run(with_attn_window(get_config("taobao_ssa"), W))` gives it, runs the
local-attention kernel in pretraining, in the ladder's fine-tuning and in
every serve call. fm, dien, din and autoint have no ladder and serve
their weights as they are; `dien` and `autoint` have no quantized variant
either (see `UNSERVABLE`). Requests come from `criteo_batches` for `fm`
and `autoint` and from `taobao_batches` otherwise, one draw of the
largest size cut to each, so the 512 point times 512 requests (`repro`'s
launcher cuts every size from a batch of 256).

Matmuls run in full f32: TF32 is switched off explicitly, since the JAX
reference is full f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RECSYS_ARCHS, RecSysConfig, get_config
from repro_torch.core.compression_loop import (
    LadderConfig, run_ladder, serving_params, variant_stats)
from repro_torch.core.distillation import make_student_cfg
from repro_torch.core.quantization import quantize_tree
from repro_torch.core.serving.engine import ElasticEngine, EngineConfig, poisson_arrivals
from repro_torch.core.serving.rate_limiter import TierPolicy
from repro_torch.core.serving.replica import LatencyModel, ReplicaSpec
from repro_torch.data.synthetic import criteo_batches, taobao_batches
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.block_pruned_matmul import ops as block_pruned_matmul_ops
from repro_torch.kernels.embedding_bag import ops as embedding_bag_ops
from repro_torch.kernels.fm_interaction import ops as fm_interaction_ops
from repro_torch.kernels.int8_matmul import ops as int8_matmul_ops
from repro_torch.kernels.local_attention import ops as local_attention_ops
from repro_torch.launch.train import make_data
from repro_torch.models.common import from_numpy_tree, init_params
from repro_torch.models.recsys import api as rec_api
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

SIZES = (1, 8, 32, 128, 512)
VARIANTS = ("baseline", "quantized", "pruned", "pruned_quantized", "distilled")
TRAINED = ("pruned", "pruned_quantized", "distilled")  # need pretraining and the ladder
TRAIN_STEPS = 40  # pretraining steps, as repro's launcher
TRAIN_BATCH = 256
TRAIN_LR = 1e-3
LADDER = LadderConfig(finetune_steps=10, qat_steps=10, distill_steps=15)  # repro's launcher's

_NO_LADDER = (
    "repro builds the trained variants for taobao_ssa only: its "
    "distillation.init_student_from_teacher (src/repro/core/distillation.py:33-39) builds a "
    "taobao_ssa student and copies the teacher's 'pos', so run_ladder raises for this arch")
_AUTOINT_BARE_MATMUL = (
    "repro's autoint._interact (src/repro/models/recsys/autoint.py:50-52) multiplies the "
    "projections with a bare @, which raises on the {kind} rep dicts {maker} makes of them")
# (interaction, variant) pairs the reference cannot serve, and why
UNSERVABLE = {
    ("augru", "quantized"): (
        "DIEN has no quantized variant: repro's dien._gru_cell "
        "(src/repro/models/recsys/dien.py:46) multiplies the GRU weights with a bare @, "
        "which raises on the int8 rep dicts quantize_tree makes of them"
    ),
    ("self_attn", "quantized"): "AutoInt has no quantized variant: " + _AUTOINT_BARE_MATMUL.format(
        kind="int8", maker="quantize_tree"),
    **{(arch, v): _NO_LADDER for arch in ("fm", "augru", "target_attn") for v in TRAINED},
    **{("self_attn", v): "AutoInt has no trained variants: repro's run_ladder raises in its "
       "first fine-tune step, where " + _AUTOINT_BARE_MATMUL.format(
           kind="masked {'w', 'mask'}", maker="prune_tree") for v in TRAINED},
}
WARMUP = 3  # untimed calls at each size before the timed ones

# traffic profiles, QPS at simulated time t: repro's launcher's
PROFILES = {
    "steady": lambda t: 300.0,
    "spike": lambda t: 150.0 if t < 15 else (1200.0 if t < 40 else 200.0),
    "ramp": lambda t: 50.0 + 20.0 * t,
}
HORIZON = 60.0  # simulated seconds

# every kernel wrapper of the port, by kernel name; each counts its launches
KERNELS = {"embedding_bag": embedding_bag_ops, "fm_interaction": fm_interaction_ops,
           "augru": augru_ops, "block_pruned_matmul": block_pruned_matmul_ops,
           "local_attention": local_attention_ops, "int8_matmul": int8_matmul_ops}


def launch_counts() -> Dict[str, int]:
    return {name: ops.launches for name, ops in KERNELS.items()}


def reset_launch_counts() -> None:
    for ops in KERNELS.values():
        ops.launches = 0


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions on the card (the reference is f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_params(path: str, device) -> Dict:
    """An .npz of "/"-joined tree paths -> the nested parameter tree on `device`."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return from_numpy_tree(tree, device)


def make_params(cfg: RecSysConfig, device, seed: int = 0) -> Dict:
    """Random parameters at the config's width, drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(rec_api.param_defs(cfg), gen, device)


def variants_for(cfg: RecSysConfig) -> Tuple[str, ...]:
    """The variants this arch serves: those of `VARIANTS` it can serve."""
    return tuple(v for v in VARIANTS if (cfg.interaction, v) not in UNSERVABLE)


def check_variants(names: Iterable[str], cfg: RecSysConfig) -> None:
    """Raise for a variant that `build_variants` cannot make for this arch."""
    for name in names:
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; the variants are {VARIANTS}")
        if (cfg.interaction, name) in UNSERVABLE:
            raise NotImplementedError(UNSERVABLE[(cfg.interaction, name)])


def has_ladder(cfg: RecSysConfig) -> bool:
    """Whether `run_ladder` builds this arch's trained variants (taobao_ssa only)."""
    return all((cfg.interaction, v) not in UNSERVABLE for v in TRAINED)


def base_params(cfg: RecSysConfig, device, params_path: Optional[str] = None,
                train_steps: int = TRAIN_STEPS):
    """The parameters every variant is built from, and the ladder's
    fine-tuning batches (None without a ladder): the loaded or seed-0
    weights, pretrained `train_steps` steps where the arch has a ladder."""
    params = load_params(params_path, device) if params_path else make_params(cfg, device)
    if not has_ladder(cfg):
        return params, None
    data = make_data(cfg, TRAIN_BATCH, device)
    params, _ = pretrain(params, cfg, data(0), train_steps)
    return params, lambda: data(1)  # every stage replays the same batches


def pretrain(params: Dict, cfg: RecSysConfig, batches, steps: int) -> Tuple[Dict, List[float]]:
    """`steps` AdamW steps at `TRAIN_LR` on `rec_api.loss`; returns the
    parameters and each step's loss."""
    opt = get_optimizer("adamw", TRAIN_LR)
    step = make_train_step(lambda p, b: rec_api.loss(p, b, cfg), opt)
    state = opt.init(params)
    losses = []
    for _, b in zip(range(steps), batches):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return params, losses


def build_variants(params: Dict, names: Iterable[str], cfg: RecSysConfig, *,
                   batch_fn=None, ladder: Optional[LadderConfig] = None) -> Dict[str, Dict]:
    """{name: the tree `serve` runs}. Without a trained variant among
    `names` this is `params` and its PTQ; with one, `run_ladder(params, cfg,
    batch_fn, ladder)` builds all five, as `repro` does, and a structured
    ladder's masked variants gain their block masks (`serving_params`)."""
    names = tuple(names)
    check_variants(names, cfg)
    if not any(n in TRAINED for n in names):
        return {name: params if name == "baseline" else quantize_tree(params) for name in names}
    if batch_fn is None:
        raise ValueError("the trained variants need batch_fn, the fine-tuning batches")
    ladder = ladder or LADDER
    built = run_ladder(params, cfg, batch_fn, ladder)
    return {name: serving_params(name, built[name]["params"], ladder) for name in names}


def request_batches(cfg: RecSysConfig, sizes: Iterable[int], device, seed: int = 2) -> Dict[int, Dict]:
    """One batch of requests per size, cut from one draw of the arch's
    generator: `criteo_batches` for FM and AutoInt, as `repro`'s launcher
    (`make_data`), `taobao_batches` (one world) else."""
    sizes = tuple(sizes)
    gen = criteo_batches if cfg.interaction in ("fm", "self_attn") else taobao_batches
    b = next(gen(cfg, max(sizes), 1, seed=seed))
    return {
        n: {k: torch.from_numpy(v[:n]).to(device) for k, v in b.items() if k != "label"}
        for n in sizes
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def variant_cfg(name: str, cfg: RecSysConfig) -> RecSysConfig:
    """The config variant `name` serves with: the distilled student's is shallower."""
    return make_student_cfg(cfg) if name == "distilled" else cfg


def calibrate_variant(params: Dict, cfg: RecSysConfig, batches: Dict[int, Dict],
                      *, reps: int = 10) -> Dict[int, Dict]:
    """Time `rec_api.serve` at each size: {size: {"ms": [..],
    "launches_per_call": {kernel: launches / call}, "probs"}}; the launches
    are the kernel wrappers', which count no call that replays a captured
    CUDA graph (`models/recsys/serve_graph`). The device is synchronised
    before each clock read, so a time covers the work and not only its
    enqueue."""
    out = {}
    for n, batch in batches.items():
        device = next(iter(batch.values())).device
        for _ in range(WARMUP):
            rec_api.serve(params, batch, cfg)
        launches0 = launch_counts()
        ms: List[float] = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            probs = rec_api.serve(params, batch, cfg)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[n] = {
            "ms": ms,
            "launches_per_call": {k: (c - launches0[k]) / reps
                                  for k, c in launch_counts().items()},
            "probs": probs,
        }
    return out


def latency_model(params: Dict, cfg: RecSysConfig, batches: Dict[int, Dict],
                  reps: int) -> LatencyModel:
    """The variant's service curve for the simulator: `LatencyModel.calibrate`
    over the sizes of `batches` (one warm call, then the mean of `reps`).
    Each call synchronises the device after it, so that the clock covers
    the work and not only its enqueue."""
    device = next(iter(next(iter(batches.values())).values())).device

    def serve_call(b: int) -> None:
        rec_api.serve(params, batches[b], cfg)
        _sync(device)

    return LatencyModel.calibrate(serve_call, tuple(batches), reps)


def curve_record(lat: LatencyModel) -> Dict:
    """A curve as JSON, exact: its sizes and its seconds at each."""
    return {"sizes": lat.sizes.tolist(), "seconds": lat.times.tolist()}


def curve_from_record(rec: Dict) -> LatencyModel:
    return LatencyModel(np.asarray(rec["sizes"], np.float64), np.asarray(rec["seconds"]))


def run_engine(name: str, lat: LatencyModel, profile: str, horizon: float = HORIZON) -> Dict:
    """`repro`'s launcher loop for one variant: its curve behind an
    `ElasticEngine` of two autoscaled replicas (p99 SLO 100 ms, two tiers),
    under `profile`'s Poisson arrivals (seed 0) for `horizon` simulated
    seconds. Returns the engine's summary."""
    spec = ReplicaSpec(name, lat, cold_start_s=5.0, warm_start_s=0.2)
    eng = ElasticEngine(
        spec,
        EngineConfig(n_replicas=2, autoscale=True, slo_p99_s=0.1),
        tiers={"tier0": TierPolicy(2000, 200), "tier1": TierPolicy(2000, 200)},
    )
    arrivals = poisson_arrivals(PROFILES[profile], horizon, seed=0)
    return eng.run(arrivals, until=horizon)


def serving_record(res: Dict, lat: LatencyModel) -> Dict:
    """`repro`'s six numbers of one variant's run."""
    return {
        "p50_ms": res["p50"] * 1e3,
        "p99_ms": res["p99"] * 1e3,
        "throughput": res["throughput"],
        "rejected": res["rejected"],
        "latency_1": lat(1) * 1e3,
        "latency_512": lat(512) * 1e3,
    }


def simulate(name: str, lat: LatencyModel, profile: str, horizon: float = HORIZON) -> Dict:
    """One variant's curve served under `profile`: `repro`'s six numbers."""
    return serving_record(run_engine(name, lat, profile, horizon), lat)


def run(cfg: Optional[RecSysConfig] = None, *, variants: Optional[Iterable[str]] = None,
        sizes: Iterable[int] = SIZES, device="cuda", params_path: Optional[str] = None,
        reps: int = 10, train_steps: int = TRAIN_STEPS,
        ladder: Optional[LadderConfig] = None, profile: Optional[str] = None,
        horizon: float = HORIZON) -> List[Dict]:
    """Build the variants (by default all the arch serves, `variants_for`)
    and time them; one record per (variant, size), then one of
    `variant_stats` when the ladder ran. taobao_ssa pretrains
    `train_steps` steps first (`base_params`); a trained variant among them
    runs `ladder` (default `LADDER`). With a `profile`, each variant's
    sizes also give its `latency_model`, served by `simulate` for
    `horizon` seconds: one record `{"arch", "variant", "curve", "serving"}`
    (`curve_record`) after the variant's timed ones."""
    if profile is not None and profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; the profiles are {sorted(PROFILES)}")
    dev = resolve_device(device)
    cfg = cfg or get_config("taobao_ssa")
    variants = tuple(variants or variants_for(cfg))
    check_variants(variants, cfg)  # before the parameters are built
    params, batch_fn = base_params(cfg, dev, params_path, train_steps)
    batches = request_batches(cfg, sizes, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    built = build_variants(params, variants, cfg, batch_fn=batch_fn, ladder=ladder)
    for name, vparams in built.items():
        vcfg = variant_cfg(name, cfg)
        for n, r in calibrate_variant(vparams, vcfg, batches, reps=reps).items():
            records.append({
                "arch": cfg.name, "variant": name, "size": n, "device": kind, "reps": reps,
                "median_ms": float(np.median(r["ms"])),
                "p90_ms": float(np.percentile(r["ms"], 90)),
                "launches_per_call": r["launches_per_call"],
            })
        if profile is not None:
            lat = latency_model(vparams, vcfg, batches, reps)
            records.append({"arch": cfg.name, "variant": name, "curve": curve_record(lat),
                            "serving": simulate(name, lat, profile, horizon)})
    if any(v in TRAINED for v in variants):
        records.append({"arch": cfg.name, "variant_stats": variant_stats(
            {name: {"params": p} for name, p in built.items()})})
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="taobao_ssa", choices=RECSYS_ARCHS)
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: the arch's own (taobao_ssa: all five, "
                         "fm and din: baseline and quantized, dien and autoint: baseline)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="taobao_ssa's pretraining steps, before any variant is built")
    ap.add_argument("--structured", action="store_true",
                    help="prune in 128 x 128 tiles (the block-pruned kernel's path)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None, help=".npz of '/'-joined parameter paths")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed calls a size, for the records and for each curve point")
    ap.add_argument("--profile", default="spike", choices=sorted(PROFILES))
    ap.add_argument("--horizon", type=float, default=HORIZON, help="simulated seconds")
    args = ap.parse_args(argv)
    if args.reps < 10:
        ap.error("--reps must be at least 10")
    disable_tf32()
    out = {"serving": {}}
    for rec in run(
        get_config(args.arch),
        variants=args.variants.split(",") if args.variants else None,
        sizes=[int(s) for s in args.sizes.split(",")],
        device=args.device, params_path=args.params, reps=args.reps,
        train_steps=args.train_steps,
        ladder=dataclasses.replace(LADDER, structured=args.structured),
        profile=args.profile, horizon=args.horizon,
    ):
        if "serving" in rec:
            r = out["serving"][rec["variant"]] = rec["serving"]
            print(f"{rec['variant']:18s} p50={r['p50_ms']:7.1f}ms p99={r['p99_ms']:7.1f}ms "
                  f"thpt={r['throughput']:7.0f}/s svc(512)={r['latency_512']:6.1f}ms", flush=True)
        elif "variant_stats" in rec:
            out["stats"] = rec["variant_stats"]
        else:
            print(json.dumps(rec), flush=True)
    print(json.dumps(out, indent=2, default=str), flush=True)


if __name__ == "__main__":
    main()
