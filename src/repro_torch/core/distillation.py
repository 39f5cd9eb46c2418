"""C3 — attention-map knowledge distillation (port of
`repro.core.distillation`, paper §III.A, Formula 3).

L_KD = KL(S_teacher ‖ S_student) over attention maps, plus soft-label
distillation on the task logits. The student is a lighter taobao_ssa:
fewer encoder layers and C1 low-rank/grouped projections, initialized from
the teacher via SVD truncation (core/lightweight.low_rank_factorize).
Singular vectors are fixed only up to sign, so a factor `a` or `b` may
differ in sign from `repro`'s; their product `a @ b` does not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.lightweight import low_rank_factorize, to_grouped
from repro_torch.models.recsys import taobao_ssa
from repro_torch.models.recsys.rec_layers import bce_with_logits


def make_student_cfg(cfg: RecSysConfig) -> RecSysConfig:
    """~30% fewer parameters: half the encoder depth (paper: 'fewer layers')."""
    return dataclasses.replace(cfg, n_attn_layers=max(1, cfg.n_attn_layers // 2))


def init_student_from_teacher(
    teacher_params: Dict, student_cfg: RecSysConfig, *, rank: int = 16,
    grouped_ffn: int = 4,
) -> Dict:
    """Student params: tables/positions/tower taken from the teacher;
    encoder projections low-rank factorized (C1) from evenly-spaced teacher
    layers; FFN w1 grouped (C1 grouped linear). `repro` first draws a random
    student and then overwrites every leaf of it from the teacher, so no
    random draw survives and none is made here. The teacher's tensors are
    shared, not copied: training replaces leaves and never writes into them."""
    keys = set(taobao_ssa.param_defs(student_cfg))
    student = {k: teacher_params[k] for k in ("tables", "pos")}
    student.update({k: teacher_params[k] for k in keys if k.startswith("tower")})
    # layer map: student layer l <- teacher layer floor(l * Lt / Ls)
    lt = sum(1 for k in teacher_params if k.startswith("enc"))
    ls = student_cfg.n_attn_layers
    for l in range(ls):
        tenc = teacher_params[f"enc{(l * lt) // ls}"]
        senc = dict(tenc)
        for proj in ("wq", "wk", "wv", "wo"):
            senc[proj] = low_rank_factorize(tenc[proj], rank)
        senc["w1"] = to_grouped(tenc["w1"], grouped_ffn)
        student[f"enc{l}"] = senc
    if set(student) != keys:
        raise ValueError(f"student keys {sorted(student)} != {sorted(keys)}")
    return student


def attention_kl(t_probs: torch.Tensor, s_probs: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Formula 3: KL(teacher ‖ student), mean over batch/heads/queries.
    Head counts may differ — both are head-averaged first (map-level KD)."""
    tm = torch.mean(t_probs, dim=1)  # [B, L, L]
    sm = torch.mean(s_probs, dim=1)
    kl = torch.sum(tm * (torch.log(tm + eps) - torch.log(sm + eps)), dim=-1)
    return torch.mean(kl)


def distill_loss(
    student_params,
    teacher_params,
    batch,
    student_cfg: RecSysConfig,
    teacher_cfg: RecSysConfig,
    *,
    alpha_attn: float = 1.0,
    alpha_soft: float = 0.5,
    temperature: float = 2.0,
) -> Tuple[torch.Tensor, Dict]:
    """Task BCE + attention-map KL + soft-label BCE. The teacher runs under
    `torch.no_grad()`: that is `repro`'s `stop_gradient` on it."""
    with torch.no_grad():
        t_logits, t_attn = taobao_ssa.logits_and_attn(
            teacher_params, batch, teacher_cfg, collect_attn=True)
    s_logits, s_attn = taobao_ssa.logits_and_attn(
        student_params, batch, student_cfg, collect_attn=True)
    task = bce_with_logits(s_logits, batch["label"])

    # student layer l distils teacher layer (l * Lt / Ls) — last maps last
    lt, ls = len(t_attn), len(s_attn)
    kd = torch.zeros((), dtype=torch.float32, device=s_logits.device)
    for l in range(ls):
        kd = kd + attention_kl(t_attn[min((l * lt) // ls, lt - 1)], s_attn[l])
    kd = kd / max(ls, 1)

    t_soft = torch.sigmoid(t_logits / temperature)
    soft = bce_with_logits(s_logits / temperature, t_soft)

    total = task + alpha_attn * kd + alpha_soft * soft
    return total, {"task": task, "attn_kl": kd, "soft": soft}
