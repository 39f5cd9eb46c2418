"""Serving launcher (serve half of `repro.launch.serve`): builds the
Table-I variants that need no training for one recsys arch at full width
and times the serve call at each batch size, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch taobao_ssa|fm|dien] \
        [--variants baseline,quantized] --sizes 1,8,32,128,512 [--device cuda] \
        [--params params.npz] [--reps 20]

Prints one JSON line per variant and size: median and p90 ms of a serve
call, and each kernel's launches per call. Parameters are random
(`init_params` on the device, from seed 0) unless `--params` names an
.npz whose keys are the tree's paths joined by "/" (e.g. "tables/item",
"enc0/wq", "tower_w0"). `quantized` is post-training quantization of those
parameters (`core/quantization.quantize_tree`); `dien` has no quantized
variant (see `build_variants`). Requests come from `criteo_batches` for
`fm` and from `taobao_batches` otherwise. Training, the pruned,
pruned_quantized and distilled variants, and the hand-off of the curves to
the serving simulator come with later slices.

Matmuls run in full f32: TF32 is switched off explicitly, since the JAX
reference is full f32.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PORTED, RecSysConfig, get_config
from repro_torch.core.quantization import quantize_tree
from repro_torch.data.synthetic import criteo_batches, taobao_batches
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.embedding_bag import ops as embedding_bag_ops
from repro_torch.kernels.fm_interaction import ops as fm_interaction_ops
from repro_torch.models.common import from_numpy_tree, init_params
from repro_torch.models.recsys import api as rec_api

SIZES = (1, 8, 32, 128, 512)
VARIANTS = ("baseline", "quantized")  # the Table-I variants that need no training
# (interaction, variant) pairs the reference cannot serve, and why
UNSERVABLE = {
    ("augru", "quantized"): (
        "DIEN has no quantized variant: repro's dien._gru_cell "
        "(src/repro/models/recsys/dien.py:46) multiplies the GRU weights with a bare @, "
        "which raises on the int8 rep dicts quantize_tree makes of them"
    ),
}
WARMUP = 3  # untimed calls at each size before the timed ones

# every kernel wrapper of the port, by kernel name; each counts its launches
KERNELS = {"embedding_bag": embedding_bag_ops, "fm_interaction": fm_interaction_ops,
           "augru": augru_ops}


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
            raise NotImplementedError(
                f"variant {name!r} needs training and comes with the training slice"
            )
        if (cfg.interaction, name) in UNSERVABLE:
            raise NotImplementedError(UNSERVABLE[(cfg.interaction, name)])


def build_variants(params: Dict, names: Iterable[str], cfg: RecSysConfig) -> Dict[str, Dict]:
    """The Table-I variants that need no training."""
    names = tuple(names)
    check_variants(names, cfg)
    return {name: params if name == "baseline" else quantize_tree(params) for name in names}


def request_batches(cfg: RecSysConfig, sizes: Iterable[int], device, seed: int = 2) -> Dict[int, Dict]:
    """One batch of requests per size, cut from one draw of the arch's
    generator: `criteo_batches` for FM, `taobao_batches` (one world) else."""
    sizes = tuple(sizes)
    gen = criteo_batches if cfg.interaction == "fm" else taobao_batches
    b = next(gen(cfg, max(sizes), 1, seed=seed))
    return {
        n: {k: torch.from_numpy(v[:n]).to(device) for k, v in b.items() if k != "label"}
        for n in sizes
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_variant(params: Dict, cfg: RecSysConfig, batches: Dict[int, Dict],
                      *, reps: int = 10) -> Dict[int, Dict]:
    """Time `rec_api.serve` at each size: {size: {"ms": [..],
    "launches_per_call": {kernel: launches / call}, "probs"}}. The device is
    synchronised before each clock read, so a time covers the work and not
    only its enqueue."""
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


def run(cfg: Optional[RecSysConfig] = None, *, variants: Optional[Iterable[str]] = None,
        sizes: Iterable[int] = SIZES, device="cuda", params_path: Optional[str] = None,
        reps: int = 10) -> List[Dict]:
    """Build the variants (by default all the arch serves, `variants_for`)
    and time them; one record per (variant, size)."""
    dev = resolve_device(device)
    cfg = cfg or get_config("taobao_ssa")
    variants = tuple(variants or variants_for(cfg))
    check_variants(variants, cfg)  # before the parameters are built
    params = load_params(params_path, dev) if params_path else make_params(cfg, dev)
    batches = request_batches(cfg, sizes, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    for name, vparams in build_variants(params, variants, cfg).items():
        for n, r in calibrate_variant(vparams, cfg, batches, reps=reps).items():
            records.append({
                "arch": cfg.name, "variant": name, "size": n, "device": kind, "reps": reps,
                "median_ms": float(np.median(r["ms"])),
                "p90_ms": float(np.percentile(r["ms"], 90)),
                "launches_per_call": r["launches_per_call"],
            })
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="taobao_ssa", choices=PORTED)
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: the arch's own (dien: baseline only)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None, help=".npz of '/'-joined parameter paths")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.reps < 10:
        ap.error("--reps must be at least 10")
    disable_tf32()
    for rec in run(
        get_config(args.arch),
        variants=args.variants.split(",") if args.variants else None,
        sizes=[int(s) for s in args.sizes.split(",")],
        device=args.device, params_path=args.params, reps=args.reps,
    ):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
