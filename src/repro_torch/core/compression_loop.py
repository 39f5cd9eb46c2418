"""The paper's closed loop (port of `repro.core.compression_loop`, §III.B
Fig 3 + §V ladder): prune → fine-tune → quantize → QAT, plus the distilled
student — producing the five Table-I variants of taobao_ssa:

  baseline / quantized / pruned / pruned_quantized / distilled

Each variant is a parameter tree in the representations of
core/lightweight.py; the SAME model code serves all five. The trees
`run_ladder` returns have exactly `repro`'s keys. With
`LadderConfig(structured=True)` the fine-tuning and QAT steps run every
masked linear through the block-pruned kernel (`pruning.with_block_masks`
is applied for them and taken off again), and `serving_params` does the
same for the structured variants a server runs.

The ladder exists for taobao_ssa only, as in `repro`: its student copies the
teacher's positions and is built as a taobao_ssa (`distillation.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

from repro_torch.configs.base import RecSysConfig
from repro_torch.core import distillation, pruning, quantization
from repro_torch.models.recsys import api as rec_api
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

MASKED_VARIANTS = ("pruned", "pruned_quantized")


@dataclasses.dataclass
class LadderConfig:
    prune_target: float = 0.4  # paper: ≈40% params removed
    prune_rounds: int = 3  # paper: K = 3
    structured: bool = False  # block-structured variant (the kernel's path)
    block: int = 128  # repro's, for prune_tree; the kernel's tile is 128, other masks are refused
    finetune_steps: int = 30
    qat_steps: int = 30
    distill_steps: int = 60
    lr: float = 1e-3


def _is_masked(x) -> bool:
    return isinstance(x, dict) and "mask" in x and "w" in x


def _restore_masks(params, ref):
    """Masks are constants of the pruning stage — never optimizer state.
    The optimizer moved them (they are float leaves with gradients, as in
    `repro`); put `ref`'s back, with its block mask where it has one."""
    if _is_masked(ref):
        return {**ref, "w": params["w"]}
    if isinstance(ref, dict):
        return {k: _restore_masks(params[k], v) for k, v in ref.items()}
    return params


def _finetune(params, cfg, batches, steps, lr, *, qat=False, structured=False, on_step=None):
    opt = get_optimizer("adamw", lr)

    def loss_fn(p, b):
        p_eff = quantization.qat_params(p) if qat else p
        return rec_api.loss(p_eff, b, cfg)

    step = make_train_step(loss_fn, opt)
    if structured:
        params = pruning.with_block_masks(params)
    state = opt.init(params)
    ref = params
    for i, b in zip(range(steps), batches):
        params, state, m = step(params, state, b)
        params = _restore_masks(params, ref)
        if on_step:
            on_step(i, m)
    return pruning.without_block_masks(params) if structured else params


def run_ladder(
    teacher_params: Dict,
    cfg: RecSysConfig,
    batch_fn: Callable[[], Iterator],
    ladder: Optional[LadderConfig] = None,
    *,
    on_step: Optional[Callable[[str, int, Dict], None]] = None,
) -> Dict[str, Dict]:
    """Returns {variant: {"params", "cfg"}} for the five Table-I rows.
    `batch_fn()` starts the fine-tuning batches afresh for each stage, as
    in `repro`. `on_step(stage, step, metrics)`, if given, sees every train
    step's metrics; the stages are "finetune1".."finetuneK", "qat" and
    "distill"."""
    lc = ladder or LadderConfig()
    if cfg.interaction != "self_attn_seq":
        raise NotImplementedError(
            f"the ladder builds taobao_ssa students only, not {cfg.name!r} "
            "(repro's distillation.init_student_from_teacher copies the teacher's "
            "'pos' and builds a taobao_ssa student)")
    out: Dict[str, Dict] = {}
    out["baseline"] = {"params": teacher_params, "cfg": cfg}

    # ---- Quantized (C5 alone: PTQ of weights + tables) ----
    out["quantized"] = {"params": quantization.quantize_tree(teacher_params), "cfg": cfg}

    # ---- Pruned (C4: K rounds of dynamic-threshold + fine-tune) ----

    def log(stage):
        return (lambda i, m: on_step(stage, i, m)) if on_step else None

    pruned = teacher_params
    for k, ratio in enumerate(pruning.prune_schedule(lc.prune_target, lc.prune_rounds), 1):
        pruned = pruning.prune_tree(pruned, ratio, structured=lc.structured, block=lc.block)
        pruned = _finetune(pruned, cfg, batch_fn(), lc.finetune_steps, lc.lr,
                           structured=lc.structured, on_step=log(f"finetune{k}"))
    out["pruned"] = {"params": pruned, "cfg": cfg}

    # ---- Pruned + Quantized (C4 → QAT → int8 storage) ----
    pq = _finetune(pruned, cfg, batch_fn(), lc.qat_steps, lc.lr, qat=True,
                   structured=lc.structured, on_step=log("qat"))
    out["pruned_quantized"] = {"params": quantization.quantize_tree(pq), "cfg": cfg}

    # ---- Distilled (C3 + C1 student) ----
    s_cfg = distillation.make_student_cfg(cfg)
    student = distillation.init_student_from_teacher(teacher_params, s_cfg)
    opt = get_optimizer("adamw", lc.lr)

    def d_loss(p, b):
        return distillation.distill_loss(p, teacher_params, b, s_cfg, cfg)

    step = make_train_step(d_loss, opt)
    state = opt.init(student)
    for i, b in zip(range(lc.distill_steps), batch_fn()):
        student, state, m = step(student, state, b)
        if on_step:
            on_step("distill", i, m)
    out["distilled"] = {"params": student, "cfg": s_cfg}
    return out


def serving_params(name: str, params: Dict, lc: LadderConfig) -> Dict:
    """The tree a server runs for variant `name`: a structured ladder's
    masked variants gain their block masks (their linears then run the
    block-pruned kernel); every other tree is served as it is."""
    if lc.structured and name in MASKED_VARIANTS:
        return pruning.with_block_masks(params)
    return params


def variant_stats(variants: Dict[str, Dict]) -> Dict[str, Dict]:
    """Params / storage / sparsity per variant (Fig 7 accounting). A
    "block_mask" is derived from "mask" and counts for nothing."""
    stats = {}
    for name, v in variants.items():
        p = v["params"]
        n_params = 0
        for leaf in quantization._model_leaves(p):
            if isinstance(leaf, dict):
                if "q" in leaf:
                    n_params += leaf["q"].numel()
                elif "w" in leaf:
                    n_params += int(leaf["mask"].sum())
                elif "a" in leaf:
                    n_params += leaf["a"].numel() + leaf["b"].numel()
                elif "gw" in leaf:
                    n_params += leaf["gw"].numel()
            else:
                n_params += leaf.numel()
        stats[name] = {
            "params": int(n_params),
            "bytes": quantization.model_bytes(p),
            "sparsity": pruning.sparsity(p),
        }
    return stats
