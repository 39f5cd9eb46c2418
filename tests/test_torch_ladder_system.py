"""The port's own pipeline end to end, on the CPU: train taobao_ssa, run
the five-variant ladder, check what `tests/test_system.py` checks of
`repro`'s (resource ordering and accuracy retention, paper Fig 6-7).

The same sizes and step counts as `test_system.py` (vocabularies cut to
1,000, 240 AdamW steps at lr 3e-3 on batches of 256, the ladder at 8/8/12
steps), with the history cut to 20 to keep the file near 40 s on one CPU
worker. Nothing of `repro` is imported.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.compression_loop import LadderConfig, run_ladder, variant_stats  # noqa: E402
from repro_torch.data.metrics import auc, ranking_metrics  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    TaobaoWorld, taobao_batches, taobao_eval_candidates,
)
from repro_torch.launch.serve import make_params  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.training.optimizer import get_optimizer  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def trained_teacher():
    cfg = get_config("taobao_ssa")
    cfg = dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields),
        seq_len=20)
    world = TaobaoWorld(1000, 1000, 1000)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    opt = get_optimizer("adamw", 3e-3)
    step = make_train_step(lambda p, b: api.loss(p, b, cfg), opt)
    state = opt.init(params)
    losses = []
    for _, b in zip(range(240), taobao_batches(cfg, 256, 10_000, world=world, seed=1)):
        params, state, m = step(params, state, _tensors(b))
        losses.append(float(m["loss"]))
    return cfg, world, params, losses


@pytest.fixture(scope="module")
def ladder(trained_teacher):
    cfg, world, params, _ = trained_teacher

    def batch_fn():
        for b in taobao_batches(cfg, 256, 10_000, world=world, seed=3):
            yield _tensors(b)

    return run_ladder(params, cfg, batch_fn,
                      LadderConfig(finetune_steps=8, qat_steps=8, distill_steps=12))


def test_training_learns(trained_teacher):
    _, _, _, losses = trained_teacher
    assert losses[-1] < losses[0] - 0.02


def test_model_beats_chance_auc(trained_teacher):
    cfg, world, params, _ = trained_teacher
    b = next(iter(taobao_batches(cfg, 2048, 1, world=world, seed=99)))
    scores = api.serve(params, _tensors(b), cfg).numpy()
    assert auc(scores, b["label"]) > 0.6


def test_ladder_produces_five_variants(ladder):
    assert set(ladder) == {"baseline", "quantized", "pruned", "pruned_quantized", "distilled"}


def test_ladder_resource_ordering(ladder):
    stats = variant_stats(ladder)
    assert stats["quantized"]["bytes"] < 0.30 * stats["baseline"]["bytes"]
    assert 0.3 < stats["pruned"]["sparsity"] < 0.5
    assert stats["pruned_quantized"]["bytes"] < stats["quantized"]["bytes"]
    assert stats["distilled"]["params"] < stats["baseline"]["params"]


def test_accuracy_retention(ladder, trained_teacher):
    cfg, world, _, _ = trained_teacher
    ev = taobao_eval_candidates(cfg, n_queries=128, n_cand=20, world=world)
    batch = _tensors(ev["batch"])

    def hr(variant):
        v = ladder[variant]
        s = api.serve(v["params"], batch, v["cfg"]).numpy()
        return ranking_metrics(s.reshape(128, 20), ev["pos_idx"], k=5)["hit_rate"]

    base = hr("baseline")
    assert base > 1.6 * 5 / 20  # well above random hit@5
    for name in ("quantized", "pruned_quantized", "distilled"):
        assert hr(name) > 0.75 * base, name


def test_ranking_metrics_and_auc_agree_with_numpy_definitions():
    scores = np.array([[0.9, 0.1, 0.5], [0.2, 0.3, 0.1]])
    m = ranking_metrics(scores, np.array([2, 0]), k=1)
    assert m == {"hit_rate": 0.0, "ndcg": 0.0, "mrr": pytest.approx((1 / 2 + 1 / 2) / 2)}
    assert auc(np.array([0.1, 0.4, 0.35, 0.8]), np.array([0, 0, 1, 1])) == 0.75
    assert auc(np.array([0.1, 0.2]), np.array([1, 1])) == 0.5
