"""What decides `correct`: the plain reference against the program, the
run's last line, faults planted under the timed path, the control on the
card, and what a run may import."""
import ast
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tiny
from harness import runner, traffic
from harness.model import make_weights, program_config
from harness.server import Server
from harness.spec import read_json

CELLS = [w["name"] for w in read_json(tiny.ROOT / "BENCHMARK.json")["workloads"]]
LOOPS = CELLS + [tiny.OPEN["name"]]  # every cell, and the open loop
SEED = 2**32 + 4_242


@pytest.mark.parametrize("name", ["ssa.rank.steady", "din.rank.bulk"])
def test_reference_matches_api_serve_at_tiny_widths(name):
    from repro_torch.models.recsys import api
    cell = tiny.tiny_cell(name)
    cfg = program_config(cell.model, exact=False)
    params = make_weights(cfg, SEED, "cpu")
    r = traffic.generate(cell.traffic, cell.model, 40, SEED, "cpu")
    got = api.serve(params, Server(api, params, cfg, r, 10**6).batch(0, 40), cfg)
    want = cell.reference().scores(params, cell.model, r, np.arange(40))
    assert got.shape == want.shape == (int(r.offsets[-1]),)
    gap = float((got - want).abs().max())
    assert gap <= 1e-6, gap  # f32 on one CPU: a few ulps of a score near 0.5
    assert float(want.std()) > 1e-3  # the scores differ by request: the check has signal


def _run(name, api=None, **kw):
    cell = tiny.tiny_cell(name, **kw)
    cell.traffic["check_requests"] = 256
    return runner.run_cell(cell, SEED, 0.5, False, "cpu", 0.0, api=api, exact=False)


@pytest.mark.parametrize("name", LOOPS)
def test_a_sound_run_is_correct_and_its_last_line_has_the_contract_shape(name):
    r = _run(name)
    line = r["line"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "check"  # the numbers compared come last
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    cell = tiny.tiny_cell(name)
    assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
    assert "setup_s" in line["metrics"]
    for c in line["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)  # one JSON object
    assert r["forbidden"] == []


class _Broken:
    """`api.serve` with a fault planted where the scores are produced."""

    def __init__(self, fault):
        from repro_torch.models.recsys import api
        self.api, self.fault = api, fault

    def serve(self, params, batch, cfg):
        s = self.api.serve(params, batch, cfg)
        if self.fault == "half_left_out":  # the second half not computed: the rest's mean
            h = s.shape[0] // 2
            s = torch.cat([s[:s.shape[0] - h], s[:s.shape[0] - h].mean().expand(h)])
        elif self.fault == "answer_altered":  # one answer of each call off by 1e-3
            s = s.clone()
            s[0] += 1e-3
        return s


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", LOOPS)
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(name, fault):
    r = _run(name, api=_Broken(fault))
    assert r["line"]["correct"] is False
    assert r["line"]["check"]["score_gap"]["value"] > r["line"]["check"]["score_gap"]["limit"]


def test_a_request_never_served_makes_the_run_incorrect():
    class Lost:
        def serve(self, params, batch, cfg):
            raise_after = getattr(self, "n", 0)
            self.n = raise_after + 1
            from repro_torch.models.recsys import api
            s = api.serve(params, batch, cfg)
            if self.n > 40:  # the loop stalls: the rest of the window is never served
                import time
                time.sleep(1.5)
            return s

    cell = tiny.tiny_cell("ssa.rank.steady")
    cell.traffic["drain_s"] = 0.5
    r = runner.run_cell(cell, SEED, 0.5, False, "cpu", 0.0, api=Lost(), exact=False)
    assert r["line"]["correct"] is False and r["line"]["failed"] > 0
    assert r["line"]["check"]["unserved"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_in_lower_precision_fails_and_the_program_passes_on_card(name):
    """The control: the reference computed with TF32 on, put in the served
    scores' place and judged by the run's own check, at the cell's own
    size and load, on three seeds: it comes out not correct where the
    program comes out correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: run `PYTHONPATH=src python -m pytest -m cuda bench/tests`")
    from harness.spec import load_cell
    cell = load_cell(name)
    for seed in (3_900_000_001, 3_900_000_002, 3_900_000_003):
        r = runner.run_cell(cell, seed, 2.0, False, "cuda", 0.0, control=True)
        limit = r["line"]["check"]["score_gap"]["limit"]
        control = r["info"]["check"]["control"]
        assert r["line"]["correct"] is True
        assert control["correct"] is False and control["numbers"]["score_gap"][0] > limit
        torch.cuda.empty_cache()


def test_a_forbidden_module_loaded_after_the_window_makes_the_run_incorrect(monkeypatch):
    """The modules are looked at once the check and the readers have run:
    a reference that loads jax on its way is caught."""
    cell = tiny.tiny_cell("ssa.rank.steady")
    cell.traffic["check_requests"] = 16
    real = cell.reference()

    def scores(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real.scores(*a, **kw)

    fake = types.SimpleNamespace(scores=scores, dot_flops=real.dot_flops)
    monkeypatch.setattr(cell, "reference", lambda: fake)
    r = runner.run_cell(cell, SEED, 0.3, False, "cpu", 0.0, exact=False)
    assert r["forbidden"] == ["jax"] and r["line"]["correct"] is False


def test_run_py_prints_no_result_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    """`run.py` looks once more just before it would print: a module loaded
    after the run's own look still stops the result, with exit code 3."""
    from harness.spec import load_module
    run_py = load_module(tiny.BENCH / "run.py", "bench_run_py")
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tiny.ROOT / "build" / "triton"))
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setattr(sys, "path", list(sys.path))

    def run_cell(*a, **kw):
        monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
        return {"line": {"correct": True, "check": {}}, "info": {}, "forbidden": []}

    monkeypatch.setattr(runner, "no_card_reason", lambda chips: None)
    monkeypatch.setattr(runner, "run_cell", run_cell)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    rc = run_py.main(["--workload", "ssa.rank.bulk", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "repro" in out.err


def _scratch_bench(tmp_path, traffic_mix: dict, config_extra: dict = None):
    """A checkout in `tmp_path` with one cell `x.cell` of a copy of
    taobao_ssa (`x_cfg`) under the mix `x.mix`."""
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    model = read_json(tiny.BENCH / "configs" / "taobao_ssa.json")
    model.update(config_extra or {})
    (bench / "configs" / "x_cfg.json").write_text(json.dumps(model))
    shutil.copy(tiny.BENCH / "configs" / "taobao_ssa.py", bench / "configs" / "x_cfg.py")
    (bench / "traffic" / "x.mix.json").write_text(json.dumps(traffic_mix))
    shutil.copy(tiny.BENCH / "metrics" / "setup_s.py", bench / "metrics" / "setup_s.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "x.cell", "config": "x_cfg", "traffic": "x.mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}))
    return bench


def test_an_arrival_process_is_found_by_name_and_an_unknown_one_fails(tmp_path):
    from harness.spec import load_cell
    mix = dict(read_json(tiny.BENCH / "traffic" / "rank.poisson.json"), arrivals="burst")
    bench = _scratch_bench(tmp_path, mix)
    with pytest.raises(ValueError, match="arrivals 'burst'"):
        load_cell("x.cell", tmp_path)
    (bench / "traffic" / "x.mix.py").write_text(
        "import numpy as np\n\n\ndef arrivals(rate, seconds, seed, mix):\n"
        "    return np.arange(0.0, seconds, 1.0 / rate)\n")
    cell = load_cell("x.cell", tmp_path)
    np.testing.assert_allclose(cell.arrivals()(4.0, 1.0, 0, cell.traffic), [0, .25, .5, .75])
    assert cell.generate() is traffic.generate
    closed = dict(read_json(tiny.BENCH / "traffic" / "rank.closed64.json"), arrivals="poisson")
    _scratch_bench(tmp_path / "c", closed)
    with pytest.raises(ValueError, match="closed loop takes no arrivals"):
        load_cell("x.cell", tmp_path / "c")


def test_a_variant_needs_its_weight_maker_beside_the_reference(tmp_path):
    from harness import model as model_mod
    from harness.spec import load_cell
    mix = read_json(tiny.BENCH / "traffic" / "rank.closed64.json")
    bench = _scratch_bench(tmp_path, mix, {"variant": "pruned_quantized"})
    with pytest.raises(ValueError, match="variant 'pruned_quantized' needs a make_weights"):
        load_cell("x.cell", tmp_path)
    with open(bench / "configs" / "x_cfg.py", "a") as f:
        f.write("\n\ndef make_weights(cfg, seed, device):\n    return {'made': seed}\n")
    cell = load_cell("x.cell", tmp_path)
    assert cell.make_weights()(None, 5, "cpu") == {"made": 5}
    assert tiny.load_cell("ssa.rank.bulk").make_weights() is model_mod.make_weights


def test_a_configuration_differs_from_the_programs_only_where_it_says():
    din = read_json(tiny.BENCH / "configs" / "din.json")
    cfg = program_config(din)  # the tables are Amazon Books', not the program's default
    assert {f.name: f.vocab for f in cfg.fields}["item"] == 367_982
    assert cfg.embed_dim == 18 and cfg.attn_mlp_dims == (80, 40)
    with pytest.raises(ValueError, match="outside its program_overrides"):
        program_config(dict(din, program_overrides=[]))
    with pytest.raises(ValueError, match="embed_dim"):
        program_config(dict(din, embed_dim=12))


def test_every_cell_finds_its_files_and_every_metric_its_reader():
    spec = read_json(tiny.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = tiny.load_cell(w["name"])
        assert cell.model["arch"] == w["config"]
        assert cell.traffic["loop"] in ("open", "closed")
        key = "rate_per_s" if cell.traffic["loop"] == "open" else "provision_per_s"
        assert key in cell.params
        assert "setup_s" in [m.name for m in cell.end_to_end] and len(cell.end_to_end) >= 2
        assert cell.per_layer
        cell.reference()
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(m.reader(), "read")
    for c in spec["configs"]:
        assert (tiny.ROOT / c["file"]).exists()
        program_config(read_json(tiny.ROOT / c["file"]))  # the file is the program's config


def test_references_import_nothing_of_the_program():
    for path in (tiny.BENCH / "configs").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "typing", "__future__"), \
                    f"{path.name} imports {n}"


def test_a_run_loads_no_jax_and_no_repro():
    """A fresh interpreter imports what a run imports (the harness, every
    reader and reference, the program's serve path and kernels) and finds
    no module whose top-level name is jax, jaxlib, flax or repro."""
    code = f"""
import sys
sys.path[:0] = [{str(tiny.ROOT / 'src')!r}, {str(tiny.BENCH)!r}]
from harness import runner, spec, server, stats, trace, traffic, work
from harness.model import program_config, make_weights
import repro_torch.kernels._build, repro_torch.kernels.embedding_bag.ops
from repro_torch.models.recsys import api
for w in {CELLS!r}:
    c = spec.load_cell(w)
    c.reference()
    for m in c.end_to_end + c.per_layer:
        m.reader()
    program_config(c.model)
print(",".join(runner.forbidden_modules()))
print(",".join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found, loaded = out.stdout.splitlines()
    assert found == ""
    assert "repro_torch" in loaded.split(",")
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded.split(","))
