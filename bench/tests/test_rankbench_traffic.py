"""The request generator and the greedy batcher, on the CPU at tiny widths.

    PYTHONPATH=src python -m pytest bench/tests -q
"""
import numpy as np
import pytest
import torch

import tiny
from harness import traffic
from harness.model import make_weights, program_config, sub_seed
from harness.server import Server

BIG_SEED = 2**31 + 987_654_321  # the driver's seeds are larger than 32 signed bits


def _cell(name="ssa.rank.steady"):
    return tiny.tiny_cell(name)


def _arrays(r):
    return [r.user, r.hist_item, r.hist_category, r.hist_len, r.item, r.category, r.cand_req,
            torch.as_tensor(r.ncand), torch.as_tensor(r.offsets)]


def test_same_seed_gives_the_same_requests_and_another_seed_others():
    cell = _cell()
    a = traffic.generate(cell.traffic, cell.model, 200, BIG_SEED, "cpu")
    b = traffic.generate(cell.traffic, cell.model, 200, BIG_SEED, "cpu")
    c = traffic.generate(cell.traffic, cell.model, 200, BIG_SEED + 1, "cpu")
    for x, y in zip(_arrays(a), _arrays(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a.hist_item, c.hist_item)
    np.testing.assert_array_equal(traffic.poisson(50.0, 3.0, BIG_SEED),
                                  traffic.poisson(50.0, 3.0, BIG_SEED))


def test_requests_follow_the_mix():
    cell = _cell()
    t, m = cell.traffic, cell.model
    r = traffic.generate(t, m, 2000, BIG_SEED, "cpu")
    lo, hi = t["hist_len"]
    assert r.hist_len.min() >= lo and r.hist_len.max() <= hi
    c = t["candidates"]
    c_lo, c_hi = (c, c) if isinstance(c, int) else c
    assert r.ncand.min() >= c_lo and r.ncand.max() <= c_hi
    assert r.offsets[0] == 0 and np.all(np.diff(r.offsets) == r.ncand)
    L = m["seq_len"]
    pad = torch.arange(L)[None] >= r.hist_len[:, None]
    assert torch.all(r.hist_item[pad] == 0)
    # the category of every item, history or candidate, is the one map's
    cats = {}
    for items, cs in ((r.hist_item.flatten(), r.hist_category.flatten()), (r.item, r.category)):
        for i, c in zip(items.tolist(), cs.tolist()):
            assert cats.setdefault(i, c) == c
    # about half the candidates are drawn from their request's valid history
    owner = r.cand_req
    in_hist = [int(r.item[k]) in set(r.hist_item[owner[k], :r.hist_len[owner[k]]].tolist())
               for k in range(0, len(r.item), 7)]
    assert 0.4 < np.mean(in_hist) < 0.7
    assert torch.equal(owner, torch.repeat_interleave(torch.arange(2000), torch.as_tensor(r.ncand)))


def test_candidates_are_log_uniform_with_the_papers_median():
    t = dict(_cell().traffic, candidates=[10, 250])
    m = _cell().model
    r = traffic.generate(t, m, 20000, BIG_SEED, "cpu")
    assert 45 <= np.median(r.ncand) <= 55
    assert 70 <= np.mean(r.ncand) <= 80


def test_a_fixed_number_of_candidates_is_every_requests():
    cell = _cell()
    assert cell.traffic["candidates"] == 5  # the cells' mixes give a number: the paper's 50
    r = traffic.generate(dict(cell.traffic, candidates=50), cell.model, 300, BIG_SEED, "cpu")
    assert np.all(r.ncand == 50) and r.offsets[-1] == 50 * 300
    with pytest.raises(ValueError, match="candidates"):
        traffic.generate(dict(cell.traffic, candidates=[5]), cell.model, 3, BIG_SEED, "cpu")


def test_items_come_from_draw_items():
    """A skew of the items is a `draw_items`: the general generator draws
    both the history pools and the other candidates through it."""
    cell = _cell()
    seen = []

    def hot(n_items, size, generator, device):
        seen.append(size)
        return torch.full(size, 7, dtype=torch.int32, device=device)

    t = dict(cell.traffic, from_history=0.0)
    r = traffic.generate(t, cell.model, 50, BIG_SEED, "cpu", draw_items=hot)
    assert len(seen) == 2 and torch.all(r.item == 7)
    valid = torch.arange(r.hist_item.shape[1])[None] < r.hist_len[:, None]
    assert torch.all(r.hist_item[valid] == 7)


def test_arrivals_are_poisson_at_the_rate():
    t = traffic.poisson(2000.0, 20.0, BIG_SEED)
    assert np.all(np.diff(t) >= 0) and t[-1] < 20.0
    assert abs(len(t) - 40000) < 5 * np.sqrt(40000)
    gaps = np.diff(t)
    assert abs(np.mean(gaps) - 1 / 2000) < 0.02 / 2000 * 10
    assert abs(np.std(gaps) / np.mean(gaps) - 1) < 0.05  # exponential: cv 1


def test_a_rate_profile_makes_bursts():
    """2 s at 1.5 x the rate every 10 s, 0.5 x between: a burst as data."""
    mix = {"rate_profile": [[8.0, 0.5], [2.0, 1.5]]}
    t = traffic.poisson(2000.0, 40.0, BIG_SEED, mix)
    assert np.all(np.diff(t) >= 0) and 0.0 <= t[0] and t[-1] < 40.0
    phase = t % 10.0
    low, high = np.sum(phase < 8.0), np.sum(phase >= 8.0)
    assert abs(low - 4 * 8 * 1000) < 5 * np.sqrt(32000)
    assert abs(high - 4 * 2 * 3000) < 5 * np.sqrt(24000)
    with pytest.raises(ValueError, match="rate_profile"):
        traffic.poisson(10.0, 1.0, 1, {"rate_profile": [[0.0, 1.0]]})


class _Echo:
    """An `api` whose serve records each batch and scores each row by its
    request's global index and candidate, so the stamping can be checked."""

    def __init__(self):
        self.batches = []

    def serve(self, params, batch, cfg):
        self.batches.append({k: v.clone() for k, v in batch.items()})
        return batch["item"].to(torch.float32)


def _server(max_rows=96, n=400):
    cell = _cell()
    r = traffic.generate(cell.traffic, cell.model, n, BIG_SEED, "cpu")
    api = _Echo()
    return Server(api, None, None, r, max_rows), api, r


def test_take_keeps_whole_requests_within_max_rows():
    s, _, r = _server(max_rows=60)
    i = 0
    while i < r.count:
        j = s.take(i, r.count)
        rows = r.offsets[j] - r.offsets[i]
        assert j > i
        assert rows <= 60 or j == i + 1  # a lone request larger than max_rows still goes
        if j < r.count:
            assert r.offsets[j + 1] - r.offsets[i] > 60  # greedy: the next one would not fit
        i = j


def test_batch_rows_are_contiguous_requests_with_their_user_history_and_req():
    s, api, r = _server()
    s.call(0.0, 0.0, 5, 9)
    b = api.batches[-1]
    a, e = int(r.offsets[5]), int(r.offsets[9])
    assert torch.equal(b["item"], r.item[a:e]) and torch.equal(b["category"], r.category[a:e])
    owner = torch.repeat_interleave(torch.arange(5, 9), torch.as_tensor(r.ncand[5:9]))
    assert torch.equal(b["req"], owner - 5)
    assert torch.all(b["req"][1:] >= b["req"][:-1])  # a request's rows are contiguous
    for k in ("user", "hist_item", "hist_category", "hist_len"):
        assert torch.equal(b[k], getattr(r, k)[owner])
    assert np.all(s.done[5:9] == s.calls[-1][4]) and np.all(np.isnan(s.done[9:]))
    np.testing.assert_array_equal(s.scores[a:e], r.item[a:e].numpy().astype(np.float32))


def test_closed_loop_sends_one_request_per_answer():
    s, api, r = _server(max_rows=96, n=20000)
    clients = 16
    end = s.closed_loop(clients, 0, r.count, 0.02, 5.0)
    sent = int(np.sum(np.isfinite(s.due)))
    assert end == sent  # every request sent is served in the drain
    for (_, _, _, _, t4, i, j) in s.calls:
        new = s.due[clients + i:clients + j]
        assert np.all((new == t4) | np.isnan(new))  # each answer sends the next at once
    assert sum(j - i for *_, i, j in s.calls) == sent


def test_closed_loop_that_runs_out_of_requests_fails():
    s, _, r = _server(n=40)
    with pytest.raises(RuntimeError, match="ran out of requests"):
        s.closed_loop(8, 0, r.count, 5.0, 1.0)


def test_open_loop_serves_in_order_from_due_times():
    s, _, r = _server(n=300)
    arrival = np.linspace(0.0, 0.3, 300, endpoint=False)
    end = s.open_loop(arrival, 0, 0.3, 5.0)
    assert end == 300
    for (_, t1, _, _, t4, i, j) in s.calls:
        assert np.all(arrival[i:j] <= t1 + 1e-9)
    lat = s.done - s.due
    assert np.all(lat > 0)


@pytest.mark.parametrize("name", ["ssa.rank.steady", "din.rank.bulk"])
def test_serve_ignores_req(name):
    """`req` rides in every batch; today's serve reads no such key, so the
    scores with and without it are the same bits."""
    from repro_torch.models.recsys import api
    cell = tiny.tiny_cell(name)
    cfg = program_config(cell.model, exact=False)
    params = make_weights(cfg, BIG_SEED, "cpu")
    r = traffic.generate(cell.traffic, cell.model, 30, BIG_SEED, "cpu")
    s = Server(api, params, cfg, r, 10_000)
    batch = s.batch(3, 30)
    with_req = api.serve(params, batch, cfg)
    batch.pop("req")
    assert torch.equal(with_req, api.serve(params, batch, cfg))


def test_sub_seeds_take_any_seed():
    assert sub_seed(2**40 + 3, 1) != sub_seed(2**40 + 3, 2)
    assert 0 <= sub_seed(-5, 1) < 2**63
