"""`api.serve`'s CUDA graph path (`repro_torch.models.recsys.serve_graph`):
which way each call goes, and on the card that a replay is the eager
call.

On the CPU: every trigger that keeps a call eager (CPU tensors, fake
tensors, `rules`, a parameter that requires grad under grad mode, an
active dispatch mode, the profiler before a capture, a first sighting, a
full cache, a cache of no graphs, a failed capture) runs
`module_for(cfg).serve` and attempts no capture. Where a trigger needs
the rest of the call to look like the card's, `serve_graph.on_card` is
made to take the CPU's tensors for the card's and the capture is stubbed;
the CPU tensors' own trigger runs with the real test. Each test serves
through a fresh `Graphs`.

On the card (`-m cuda`; this file imports no JAX):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_serve_graph.py

a replay gives `module_for(cfg).serve`'s bits for taobao_ssa, DIN and
taobao_ssa under the C2 window (`local_attention`), and runs on the card,
counted on the device trace by kernel name, the hand-written kernels the
eager call runs, while the kernel wrappers' `launches` count no replay; a
replaced parameter leaf is never served from the stale graph, and one
changed in place is read afresh; scores returned by one call stay as they
were after the next; two signatures, alternated, each keep their bits; a
call with a host sync, found by the capture's warm-up, and a call that
CUDA refuses while capturing each stay eager for good and leave nothing
behind: the card's generator draws on, and a later capture works.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import get_config, with_attn_window  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.serve import launch_counts  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.models.recsys import api, serve_graph  # noqa: E402

B, L, VOCAB = 8, 6, 300
ARCHS = ["taobao_ssa", "din", "taobao_ssa_c2"]
# each kernel wrapper's kernels on the device trace, by a part of their names
KERNEL_SYMBOL = {"embedding_bag": "embedding_bag_kernel",
                 "fm_interaction": "fm_interaction_kernel", "augru": "augru_kernel",
                 "block_pruned_matmul": "block_pruned_matmul_",
                 "local_attention": "local_attention_kernel", "int8_matmul": "int8_matmul_kernel"}


def _cfg(arch, seq_len=L, vocab=VOCAB):
    base = get_config("taobao_ssa" if arch == "taobao_ssa_c2" else arch)
    fields = tuple(dataclasses.replace(f, vocab=min(f.vocab, vocab),
                                       multi_hot=seq_len if f.multi_hot > 1 else 1)
                   for f in base.fields)
    cfg = dataclasses.replace(base, fields=fields, seq_len=seq_len)
    return with_attn_window(cfg, 4) if arch == "taobao_ssa_c2" else cfg


def _batch(rows, seq_len, device, seed, vocab=VOCAB):
    g = torch.Generator().manual_seed(seed)
    ids = lambda *shape: torch.randint(0, vocab, shape, generator=g)  # noqa: E731
    batch = {"user": ids(rows), "item": ids(rows), "category": ids(rows),
             "hist_item": ids(rows, seq_len), "hist_category": ids(rows, seq_len),
             "hist_len": torch.randint(0, seq_len + 1, (rows,), generator=g)}
    return {k: v.to(device) for k, v in batch.items()}


def _world(arch, device="cpu", rows=B, seq_len=L):
    cfg = _cfg(arch, seq_len)
    params = init_params(api.param_defs(cfg), torch.Generator().manual_seed(0), device)
    return cfg, params, _batch(rows, seq_len, device, 1)


class _Tracked(serve_graph.Graphs):
    """A cache whose `paths` lists the way each call went, as `path` told
    `api.serve`."""

    def __init__(self, most=serve_graph.MAX_GRAPHS):
        super().__init__(most)
        self.paths = []

    def path(self, *args):
        out = super().path(*args)
        self.paths.append(out[0])
        return out


@pytest.fixture
def graphs(monkeypatch):
    """A fresh cache for the test."""
    fresh = _Tracked()
    monkeypatch.setattr(serve_graph, "GRAPHS", fresh)
    return fresh


@pytest.fixture
def captures(graphs, monkeypatch):
    """The CPU's tensors taken for the card's, and the capture, which needs
    the card, stubbed as refused, so the call runs as written. Returns the
    list of the captures attempted ("capture" each)."""
    tried = []

    def capture(self, fn, params, batch, cfg):
        tried.append("capture")
        return None

    monkeypatch.setattr(serve_graph, "on_card", lambda t: not serve_graph.is_fake(t))
    monkeypatch.setattr(serve_graph.Graphs, "_capture", capture)
    return tried


def _eager(cfg, params, batch):
    return api.module_for(cfg).serve(params, batch, cfg, None)


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_tensors_stay_eager_and_attempt_no_capture(arch, graphs, monkeypatch):
    monkeypatch.setattr(serve_graph.Graphs, "_capture",
                        lambda *a: pytest.fail("the graph path was taken"))
    cfg, params, batch = _world(arch)
    for _ in range(3):
        assert torch.equal(api.serve(params, batch, cfg), _eager(cfg, params, batch))
    assert graphs.paths == ["eager"] * 3
    assert graphs.graphs == {} and graphs.once == set()


def test_the_second_sighting_captures_where_nothing_keeps_the_call_eager(captures, graphs):
    """The control of the triggers below: with the CPU's tensors taken for
    the card's, the first call runs as written and the second attempts a
    capture; the refused capture leaves the signature eager for good, and
    it is no longer noted as seen once."""
    cfg, params, batch = _world("din")
    want = _eager(cfg, params, batch)
    for _ in range(4):
        assert torch.equal(api.serve(params, batch, cfg), want)
    assert graphs.paths == ["eager", "capture", "eager", "eager"]
    assert captures == ["capture"]
    assert list(graphs.graphs.values()) == [None] and graphs.once == set()


def test_a_first_sighting_runs_as_written_and_keeps_no_buffer(captures, graphs, monkeypatch):
    """A signature seen once runs `module_for(cfg).serve` on the caller's
    own batch, and the cache keeps its signature alone."""
    real = api.module_for
    given = []

    def serve(params, batch, cfg, rules):
        given.append(batch)
        return real(cfg).serve(params, batch, cfg, rules)

    cfg, params, batch = _world("din")
    want = _eager(cfg, params, batch)
    monkeypatch.setattr(api, "module_for", lambda cfg: types.SimpleNamespace(serve=serve))
    assert torch.equal(api.serve(params, batch, cfg), want)
    assert len(given) == 1 and given[0] is batch
    assert graphs.paths == ["eager"] and captures == [] and graphs.graphs == {}
    assert graphs.once == {serve_graph.signature(params, batch, cfg)}


@pytest.mark.parametrize("trigger", ["rules", "requires_grad", "dispatch_mode", "profiler"])
def test_each_trigger_keeps_the_call_eager_and_attempts_no_capture(trigger, captures, graphs):
    cfg, params, batch = _world("din")
    want = _eager(cfg, params, batch)
    rules = {} if trigger == "rules" else None  # one rank's rules: no mesh, whole tables
    if trigger == "requires_grad":
        params["tower_w0"].requires_grad_(True)
    for _ in range(3):
        if trigger == "dispatch_mode":
            with hlo_stats.Counter():
                got = api.serve(params, batch, cfg, rules)
        elif trigger == "profiler":
            with profile(activities=[ProfilerActivity.CPU]):
                got = api.serve(params, batch, cfg, rules)
        else:
            got = api.serve(params, batch, cfg, rules)
        assert torch.equal(got.detach(), want)
    assert graphs.paths == ["eager"] * 3
    assert captures == [] and graphs.graphs == {} and graphs.once == set()


def test_grad_mode_off_lets_a_parameter_that_requires_grad_capture(captures, graphs):
    cfg, params, batch = _world("din")
    params["tower_w0"].requires_grad_(True)
    with torch.no_grad():
        for _ in range(2):
            api.serve(params, batch, cfg)
    assert captures == ["capture"]


def test_fake_tensors_stay_eager():
    """The dry run's tensors: fake, on a CUDA device, without storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _cfg("din")
    with FakeTensorMode():
        params = {"w": torch.empty(4, 3, device="cuda")}
        batch = {"user": torch.zeros(B, dtype=torch.int64, device="cuda")}
    assert params["w"].is_cuda and serve_graph.is_fake(params["w"])
    g = serve_graph.Graphs()
    for _ in range(3):
        assert g.path(params, batch, cfg, None) == ("eager", None)
    assert g.graphs == {} and g.once == set()


def test_a_full_cache_keeps_a_new_signature_eager(captures, graphs):
    cfg, params, batch = _world("din")
    for k in range(serve_graph.MAX_GRAPHS):
        graphs.graphs[("another", k)] = None
    for _ in range(3):
        api.serve(params, batch, cfg)
    assert graphs.paths == ["eager"] * 3 and captures == []


def test_a_cache_of_no_graphs_runs_every_call_as_written(captures, monkeypatch):
    none = _Tracked(most=0)
    monkeypatch.setattr(serve_graph, "GRAPHS", none)
    cfg, params, batch = _world("din")
    for _ in range(3):
        assert torch.equal(api.serve(params, batch, cfg), _eager(cfg, params, batch))
    assert none.paths == ["eager"] * 3 and captures == []
    assert none.graphs == {} and none.once == set()


def test_signatures_seen_once_are_forgotten_all_at_once_past_their_bound(captures, graphs,
                                                                         monkeypatch):
    monkeypatch.setattr(serve_graph, "MAX_ONCE", 3)
    cfg, params, _ = _world("din")
    batches = [_batch(B + k, L, "cpu", k) for k in range(4)]
    sigs = [serve_graph.signature(params, b, cfg) for b in batches]
    for b in batches[:3]:
        assert graphs.path(params, b, cfg, None) == ("eager", None)
    assert graphs.once == set(sigs[:3])
    assert graphs.path(params, batches[3], cfg, None) == ("eager", None)
    assert graphs.once == {sigs[3]}
    assert graphs.path(params, batches[0], cfg, None) == ("eager", None)  # forgotten
    assert graphs.path(params, batches[3], cfg, None) == ("capture", sigs[3])
    assert captures == []


def test_the_signature_follows_batch_shapes_config_and_leaves(monkeypatch):
    monkeypatch.setattr(serve_graph, "on_card", lambda t: True)
    cfg, params, batch = _world("din")
    sig = serve_graph.signature(params, batch, cfg)
    assert sig == serve_graph.signature(params, dict(batch), cfg)
    params["tower_w0"].mul_(2.0)  # changed in place: the graph reads it afresh
    assert serve_graph.signature(params, batch, cfg) == sig
    others = [
        serve_graph.signature(params, _batch(B + 1, L, "cpu", 1), cfg),
        serve_graph.signature(params, dict(batch, hist_len=batch["hist_len"].int()), cfg),
        serve_graph.signature(params, dict(batch, extra=batch["user"]), cfg),
        serve_graph.signature(params, batch, dataclasses.replace(cfg)),
        serve_graph.signature(dict(params, tower_w0=params["tower_w0"].clone()), batch, cfg),
    ]
    assert sig not in others and len(set(others)) == len(others)
    # what takes no graph: a batch entry that is no tensor, or is not
    # contiguous (a replay copies it in flat), and a leaf that is no tensor
    transposed = batch["hist_item"].t().contiguous().t()
    assert not transposed.is_contiguous()
    assert serve_graph.signature(params, dict(batch, hist_item=transposed), cfg) is None
    assert serve_graph.signature(params, dict(batch, user=3), cfg) is None
    assert serve_graph.signature(dict(params, note="x"), batch, cfg) is None


def test_static_inputs_are_packed_one_buffer_a_dtype_each_on_its_own_block():
    g = torch.Generator().manual_seed(7)
    batch = {"a": torch.randint(0, 9, (37,), generator=g, dtype=torch.int32),
             "b": torch.randint(0, 9, (5, 41), generator=g, dtype=torch.int32),
             "c": torch.randint(0, 9, (13,), generator=g),
             "d": torch.tensor(3, dtype=torch.int32),
             "e": torch.rand(2, 3, generator=g)}
    inputs, packs = serve_graph.pack(batch)
    assert len(packs) == 3  # int32, int64, float32
    base = {flat.dtype: flat.data_ptr() for flat, _ in packs}
    for k, t in batch.items():
        assert torch.equal(inputs[k], t) and inputs[k].dtype == t.dtype
        assert (inputs[k].data_ptr() - base[t.dtype]) % serve_graph.ALIGN_BYTES == 0
    again = {k: (t + 1).to(t.dtype) for k, t in batch.items()}
    serve_graph.fill(packs, again)
    for k in batch:
        assert torch.equal(inputs[k], again[k])


def _stand_in():
    """A captured call without a card: its graph's replay does nothing."""
    inputs, packs = serve_graph.pack({"x": torch.zeros(3)})
    entry = serve_graph._Graph(types.SimpleNamespace(replay=lambda: None), packs,
                               torch.arange(3.0), None)
    return entry, inputs


def test_the_root_span_records_the_path(captures, graphs, monkeypatch):
    """Under the profiler a signature seen once stays eager, and one with a
    graph replays, with no span below the root: the replay runs none of
    the layers' code."""
    cfg, params, batch = _world("din")
    api.serve(params, batch, cfg)  # unprofiled: the next profiled call starts a recording
    monkeypatch.setattr(serve_graph, "_replay", lambda entry, batch: entry.out.clone())
    with profile(activities=[ProfilerActivity.CPU]):
        api.serve(params, batch, cfg)
        graphs.graphs[serve_graph.signature(params, batch, cfg)] = _stand_in()[0]
        api.serve(params, batch, cfg)
    rec = spans.recording()
    rows = [(rec.names[n], int(p)) for n, p in zip(rec.column("name"), rec.column("parent"))]
    assert [r for r in rows if r[1] == -1] == [(("serve", "eager"), -1), (("serve", "replay"), -1)]
    assert rows[-1] == (("serve", "replay"), -1)
    assert graphs.paths == ["eager", "eager", "replay"] and captures == []


def test_a_replay_fills_the_static_inputs_and_leaves_the_launch_counts_alone():
    """A replay copies the batch into the static inputs and returns a clone
    of the static output; the kernel wrappers count no replay (they count
    where they launch, and a replay runs none of their code)."""
    entry, inputs = _stand_in()
    before = launch_counts()
    out = serve_graph._replay(entry, {"x": torch.ones(3)})
    assert launch_counts() == before
    assert torch.equal(inputs["x"], torch.ones(3))
    out.add_(1.0)
    assert torch.equal(entry.out, torch.arange(3.0))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_world(arch, device):
    cfg = _cfg(arch, 20, 1000)
    params = init_params(api.param_defs(cfg), torch.Generator().manual_seed(0), device)
    return cfg, params


def _launched(fn, *args):
    """fn's result and each kernel wrapper's launches in it."""
    before = launch_counts()
    out = fn(*args)
    return out, {k: n - before[k] for k, n in launch_counts().items()}


def _traced(fn, *args):
    """fn's result, each kernel wrapper's launches in it, and the kernels
    of each wrapper's family that ran on the card in it, counted on the
    device trace (CUDA activity alone, as the benchmark's trace) by name."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, launches = _launched(fn, *args)
        torch.cuda.synchronize()
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA]
    return out, launches, {k: sum(sym in n for n in names) for k, sym in KERNEL_SYMBOL.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_is_the_eager_calls_bits_and_launches_on_card(arch, cuda_device, graphs):
    """The first two calls run unprofiled (nothing is captured under the
    profiler): as written, then warmed up and captured, the wrappers
    counting both runs; each replay after them, traced, runs the eager
    call's hand-written kernels, and its wrappers count nothing."""
    cfg, params = _card_world(arch, cuda_device)
    none = {k: 0 for k in KERNEL_SYMBOL}
    for k in range(5):
        batch = _batch(64, 20, cuda_device, 10 + k, 1000)
        want, eager, on_card = _traced(_eager, cfg, params, batch)
        assert eager == on_card, (arch, k)
        if k < 2:
            got, launches = _launched(api.serve, params, batch, cfg)
            assert launches == {n: (k + 1) * c for n, c in eager.items()}, (arch, k)
        else:
            got, launches, replayed = _traced(api.serve, params, batch, cfg)
            assert launches == none and replayed == on_card, (arch, k, replayed)
        assert torch.equal(got, want), (arch, k, graphs.paths[-1])
    assert graphs.paths == ["eager", "capture", "replay", "replay", "replay"]
    kernel = "local_attention" if arch == "taobao_ssa_c2" else "embedding_bag"
    assert eager[kernel] > 0


@pytest.mark.cuda
def test_a_replaced_leaf_is_never_served_from_the_stale_graph_on_card(cuda_device, graphs):
    cfg, params = _card_world("din", cuda_device)
    batch = _batch(64, 20, cuda_device, 3, 1000)
    for _ in range(3):
        api.serve(params, batch, cfg)
    old = api.serve(params, batch, cfg)
    assert graphs.paths[-1] == "replay"
    params["tower_w0"] = params["tower_w0"] * 1.5  # a new tensor, at another address
    for k in range(3):
        got = api.serve(params, batch, cfg)
        assert torch.equal(got, _eager(cfg, params, batch)), k
        assert not torch.equal(got, old)
    assert graphs.paths[-3:] == ["eager", "capture", "replay"]
    params["tower_w0"].mul_(0.5)  # in place: the graph reads it where it lies
    assert torch.equal(api.serve(params, batch, cfg), _eager(cfg, params, batch))
    assert graphs.paths[-1] == "replay"


@pytest.mark.cuda
def test_scores_of_one_call_stay_after_the_next_on_card(cuda_device, graphs):
    cfg, params = _card_world("taobao_ssa", cuda_device)
    first = [api.serve(params, _batch(64, 20, cuda_device, 20 + k, 1000), cfg)
             for k in range(4)]
    kept = [t.clone() for t in first]
    api.serve(params, _batch(64, 20, cuda_device, 99, 1000), cfg)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[2], first[3])
    assert graphs.paths == ["eager", "capture", "replay", "replay", "replay"]


@pytest.mark.cuda
def test_two_signatures_alternated_each_keep_their_bits_on_card(cuda_device, graphs):
    cfg, params = _card_world("din", cuda_device)
    for k in range(8):
        rows = 64 if k % 2 else 48
        batch = _batch(rows, 20, cuda_device, 40 + k, 1000)
        want = _eager(cfg, params, batch)
        got = api.serve(params, batch, cfg)
        assert got.shape == (rows,) and torch.equal(got, want), k
    assert graphs.paths == ["eager"] * 2 + ["capture"] * 2 + ["replay"] * 4


@pytest.mark.cuda
def test_a_refused_capture_stays_eager_and_leaves_nothing_behind_on_card(cuda_device, graphs,
                                                                        monkeypatch):
    """A call with a host sync inside cannot be captured: the warm-up at
    its second sighting finds it, before any capture, the signature stays
    eager for good, and the caller's stream, the memory in use, the launch
    counts and the sync debug mode read as before; the card's generator
    draws, and the next model captures and replays."""
    real = api.module_for

    def serve(params, batch, cfg, rules):
        x = batch["user"].float() * params["w"]
        return x + float(x.sum())  # the host waits for the card

    monkeypatch.setattr(api, "module_for", lambda cfg: types.SimpleNamespace(serve=serve))
    cfg = _cfg("din")
    params = {"w": torch.full((64,), 0.5, device=cuda_device)}
    batch = {"user": torch.arange(64, device=cuda_device)}
    want = serve(params, batch, cfg, None)
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    used = torch.cuda.memory_allocated()
    counts = launch_counts()
    for _ in range(4):
        got = api.serve(params, batch, cfg)
        assert torch.equal(got, want)
        del got
    torch.cuda.synchronize()
    assert torch.cuda.current_stream() == stream
    assert torch.cuda.memory_allocated() == used
    assert launch_counts() == counts
    assert list(graphs.graphs.values()) == [None] and graphs.once == set()
    assert graphs.paths == ["eager", "capture", "eager", "eager"]
    assert torch.cuda.get_sync_debug_mode() == 0
    assert torch.randn(3, device=cuda_device).isfinite().all()
    monkeypatch.setattr(api, "module_for", real)
    cfg, params = _card_world("din", cuda_device)
    batch = _batch(64, 20, cuda_device, 5, 1000)
    for _ in range(3):
        assert torch.equal(api.serve(params, batch, cfg), _eager(cfg, params, batch))
    assert graphs.paths[-3:] == ["eager", "capture", "replay"]


@pytest.mark.cuda
def test_a_capture_refused_midway_leaves_the_generator_and_later_captures_working_on_card(
        cuda_device, graphs, monkeypatch):
    """A call that its warm-up passes but that CUDA refuses while capturing
    (the host waits for the capture stream, only under capture): CUDA
    invalidates the capture, `capture_end` raises, the signature stays
    eager for good, and what the refusal left set is put back: no stream
    captures, the memory in use reads as before, the card's generator draws
    on from where it stood, and the next model captures, into a new pool,
    and replays its eager bits."""
    real = api.module_for

    def serve(params, batch, cfg, rules):
        x = batch["user"].float() * params["w"]
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.current_stream().synchronize()
        return x

    monkeypatch.setattr(api, "module_for", lambda cfg: types.SimpleNamespace(serve=serve))
    cfg = _cfg("din")
    params = {"w": torch.full((64,), 0.5, device=cuda_device)}
    batch = {"user": torch.arange(64, device=cuda_device)}
    want = serve(params, batch, cfg, None)
    torch.cuda.synchronize()
    used = torch.cuda.memory_allocated()
    state = torch.cuda.get_rng_state()
    for _ in range(3):
        assert torch.equal(api.serve(params, batch, cfg), want)
    assert graphs.paths == ["eager", "capture", "eager"]
    assert list(graphs.graphs.values()) == [None] and graphs.once == set()
    torch.cuda.synchronize()
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.memory_allocated() == used
    assert torch.equal(torch.cuda.get_rng_state(), state)
    drawn = torch.rand(8, device=cuda_device)
    torch.cuda.set_rng_state(state)
    assert torch.equal(torch.rand(8, device=cuda_device), drawn)
    monkeypatch.setattr(api, "module_for", real)
    cfg, params = _card_world("din", cuda_device)
    batch = _batch(64, 20, cuda_device, 6, 1000)
    for _ in range(3):
        assert torch.equal(api.serve(params, batch, cfg), _eager(cfg, params, batch))
    assert graphs.paths[-3:] == ["eager", "capture", "replay"]
    assert len(graphs.spent) == 1 and graphs.pool is not graphs.spent[0]
    assert torch.rand(8, device=cuda_device).isfinite().all()
