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


def _tiny():
    cfg = get_config("taobao_ssa")
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 300)) for f in cfg.fields),
        seq_len=12,
    )


def test_serve_on_cpu_answers_each_size():
    recs = serve.run(_tiny(), sizes=(1, 8), device="cpu", reps=10)
    assert [(r["variant"], r["size"]) for r in recs] == [
        ("baseline", 1), ("baseline", 8), ("quantized", 1), ("quantized", 8)]
    for r in recs:
        assert r["device"] == "cpu" and r["reps"] == 10
        assert math.isfinite(r["median_ms"]) and 0 < r["median_ms"] <= r["p90_ms"]
        assert r["launches_per_call"] == 0  # CPU tensors take the plain path
        json.dumps(r)


def test_calibrated_outputs_are_probabilities():
    cfg = _tiny()
    params = serve.make_params(cfg, torch.device("cpu"), seed=1)
    batches = serve.request_batches(cfg, (1, 8), torch.device("cpu"))
    for vparams in serve.build_variants(params, serve.VARIANTS).values():
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
        serve.build_variants({}, ["pruned"])


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

    with pytest.raises(NotImplementedError, match="FM slice"):
        get_config("fm")
    with pytest.raises(KeyError):
        get_config("no_such_arch")
    with pytest.raises(NotImplementedError):
        api.module_for(dataclasses.replace(_tiny(), interaction="augru"))
