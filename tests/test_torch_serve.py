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

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import to_numpy_tree  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _tiny(arch="taobao_ssa"):
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 300)) for f in cfg.fields),
        seq_len=12,
    )

NO_LAUNCHES = {"embedding_bag": 0, "fm_interaction": 0, "augru": 0}


def test_serve_on_cpu_answers_each_size():
    recs = serve.run(_tiny(), sizes=(1, 8), device="cpu", reps=10)
    assert [(r["variant"], r["size"]) for r in recs] == [
        ("baseline", 1), ("baseline", 8), ("quantized", 1), ("quantized", 8)]
    for r in recs:
        assert r["device"] == "cpu" and r["reps"] == 10 and r["arch"] == "taobao_ssa"
        assert math.isfinite(r["median_ms"]) and 0 < r["median_ms"] <= r["p90_ms"]
        assert r["launches_per_call"] == NO_LAUNCHES  # CPU tensors take the plain path
        json.dumps(r)


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
    params = serve.make_params(cfg, torch.device("cpu"), seed=1)
    batches = serve.request_batches(cfg, (1, 8), torch.device("cpu"))
    for vparams in serve.build_variants(params, serve.VARIANTS, cfg).values():
        for n, r in serve.calibrate_variant(vparams, cfg, batches, reps=10).items():
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


def test_untrained_variants_are_refused():
    with pytest.raises(NotImplementedError):
        serve.build_variants({}, ["pruned"], _tiny())


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
