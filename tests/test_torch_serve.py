"""The port's serve launcher: it answers on the CPU only when asked to, and
never falls back to the CPU on its own."""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.compression_loop import LadderConfig, run_ladder  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.common import to_numpy_tree, tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _tiny(arch="taobao_ssa"):
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 300)) for f in cfg.fields),
        seq_len=12,
    )

NO_LAUNCHES = {"embedding_bag": 0, "fm_interaction": 0, "augru": 0, "block_pruned_matmul": 0}
SHORT_LADDER = LadderConfig(finetune_steps=2, qat_steps=2, distill_steps=2)


def test_serve_on_cpu_answers_each_size():
    """taobao_ssa's default: all five variants, after the launcher's own
    pretraining (40 steps) and ladder (10/10/15 steps), as `repro`'s."""
    recs = serve.run(_tiny(), sizes=(1, 8), device="cpu", reps=10)
    *timed, stats = recs
    assert [(r["variant"], r["size"]) for r in timed] == [
        (v, n) for v in serve.VARIANTS for n in (1, 8)]
    for r in timed:
        assert r["device"] == "cpu" and r["reps"] == 10 and r["arch"] == "taobao_ssa"
        assert math.isfinite(r["median_ms"]) and 0 < r["median_ms"] <= r["p90_ms"]
        assert r["launches_per_call"] == NO_LAUNCHES  # CPU tensors take the plain path
        json.dumps(r)
    assert set(stats["variant_stats"]) == set(serve.VARIANTS)
    assert 0.3 < stats["variant_stats"]["pruned"]["sparsity"] < 0.5
    json.dumps(stats)


@pytest.mark.parametrize("structured", [False, True])
def test_launcher_builds_and_serves_the_five_taobao_ssa_variants(structured):
    """The trained variants at a tiny size, the structured ladder too: its
    masked variants carry block masks, and every call gives probabilities."""
    cfg = _tiny()
    dev = torch.device("cpu")
    data = train.make_data(cfg, 32, dev)
    params, losses = serve.pretrain(serve.make_params(cfg, dev, seed=1), cfg, data(0), 3)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    ladder = dataclasses.replace(SHORT_LADDER, structured=structured)
    built = serve.build_variants(params, serve.VARIANTS, cfg, batch_fn=lambda: data(1),
                                 ladder=ladder)
    assert tuple(built) == serve.VARIANTS
    for name in ("pruned", "pruned_quantized"):
        assert ("block_mask" in built[name]["enc0"]["w1"]) == structured
    batches = serve.request_batches(cfg, (1, 8), dev)
    for name, vparams in built.items():
        vcfg = serve.variant_cfg(name, cfg)
        for n, r in serve.calibrate_variant(vparams, vcfg, batches, reps=10).items():
            p = r["probs"]
            assert p.shape == (n,) and bool(((p > 0) & (p < 1)).all()), name
            assert r["launches_per_call"] == NO_LAUNCHES
    assert serve.variant_cfg("distilled", cfg).n_attn_layers == 1


def test_taobao_ssa_pretrains_whatever_the_variants_and_fm_does_not():
    """`baseline` names the same tree in every run: taobao_ssa's launcher
    pretrains before building any variant, as `repro`'s does; fm, which has
    no ladder, serves its seed-0 weights."""
    dev = torch.device("cpu")
    cfg = _tiny()
    init = serve.make_params(cfg, dev)
    params, batch_fn = serve.base_params(cfg, dev, train_steps=2)
    assert batch_fn is not None and serve.has_ladder(cfg)
    assert not torch.equal(params["enc0"]["wq"], init["enc0"]["wq"])
    again, _ = serve.base_params(cfg, dev, train_steps=2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(params),
                                                           tree_leaves(again)))
    fm = _tiny("fm")
    fm_params, fm_batches = serve.base_params(fm, dev, train_steps=2)
    assert fm_batches is None and not serve.has_ladder(fm)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(fm_params), tree_leaves(serve.make_params(fm, dev))))


def test_trained_variants_need_batches():
    with pytest.raises(ValueError, match="batch_fn"):
        serve.build_variants({}, ["pruned"], _tiny())


@pytest.mark.parametrize("arch,variants", [("fm", ["baseline", "quantized"]),
                                           ("dien", ["baseline"])])
def test_serve_other_archs_on_cpu(arch, variants):
    """--arch fm and dien at a tiny size: the arch's own default variants,
    its own request generator, probabilities out of every call."""
    cfg = _tiny(arch)
    recs = serve.run(cfg, sizes=(1, 8), device="cpu", reps=10)
    assert [(r["variant"], r["size"]) for r in recs] == [(v, n) for v in variants for n in (1, 8)]
    for r in recs:
        assert r["arch"] == arch and r["launches_per_call"] == NO_LAUNCHES
        assert math.isfinite(r["median_ms"]) and 0 < r["median_ms"] <= r["p90_ms"]
    batches = serve.request_batches(cfg, (1, 8), torch.device("cpu"))
    key = "sparse_idx" if arch == "fm" else "hist_item"
    assert batches[8][key].shape[0] == 8 and "label" not in batches[8]
    params = serve.make_params(cfg, torch.device("cpu"), seed=1)
    for vparams in serve.build_variants(params, variants, cfg).values():
        p = serve.calibrate_variant(vparams, cfg, batches, reps=10)[8]["probs"]
        assert p.shape == (8,) and bool(((p > 0) & (p < 1)).all())


def test_calibrated_outputs_are_probabilities():
    cfg = _tiny()
    dev = torch.device("cpu")
    params = serve.make_params(cfg, dev, seed=1)
    batches = serve.request_batches(cfg, (1, 8), dev)
    data = train.make_data(cfg, 32, dev)
    built = serve.build_variants(params, serve.VARIANTS, cfg, batch_fn=lambda: data(1),
                                 ladder=SHORT_LADDER)
    for name, vparams in built.items():
        vcfg = serve.variant_cfg(name, cfg)
        for n, r in serve.calibrate_variant(vparams, vcfg, batches, reps=10).items():
            p = r["probs"]
            assert p.shape == (n,) and bool(((p > 0) & (p < 1)).all())


def test_params_file_loads_the_same_tree(tmp_path):
    cfg = _tiny()
    params = serve.make_params(cfg, torch.device("cpu"), seed=2)
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[prefix + k] = v
    walk("", to_numpy_tree(params))
    np.savez(tmp_path / "p.npz", **flat)
    loaded = serve.load_params(str(tmp_path / "p.npz"), "cpu")
    assert loaded.keys() == params.keys()
    assert torch.equal(loaded["tables"]["item"], params["tables"]["item"])
    assert torch.equal(loaded["enc1"]["w2"], params["enc1"]["w2"])


@pytest.mark.parametrize("arch", ["fm", "dien"])
@pytest.mark.parametrize("variant", ["pruned", "pruned_quantized", "distilled"])
def test_untrained_variants_are_refused(arch, variant):
    """repro's ladder builds taobao_ssa students only, so FM and DIEN have
    no trained variant (nor does the port's run_ladder)."""
    cfg = _tiny(arch)
    with pytest.raises(NotImplementedError, match="taobao_ssa"):
        serve.build_variants({}, [variant], cfg)
    with pytest.raises(NotImplementedError, match="taobao_ssa"):
        serve.run(cfg, variants=[variant], sizes=(1,), device="cpu")
    assert variant not in serve.variants_for(cfg)
    if arch == "fm":
        with pytest.raises(NotImplementedError, match="taobao_ssa"):
            run_ladder({}, cfg, lambda: iter(()))


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="unknown variant"):
        serve.build_variants({}, ["sparse"], _tiny())


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.run(_tiny(), sizes=(1,))


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--sizes", "1"],
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert r.returncode != 0 and "cuda" in r.stderr
    assert r.stdout == ""


def test_unported_arch_and_interaction_raise():
    from repro_torch.models.recsys import api

    with pytest.raises(NotImplementedError, match="recsys-families slice"):
        get_config("din")
    with pytest.raises(KeyError):
        get_config("no_such_arch")
    with pytest.raises(NotImplementedError, match="DIN"):
        api.module_for(dataclasses.replace(_tiny(), interaction="target_attn"))
