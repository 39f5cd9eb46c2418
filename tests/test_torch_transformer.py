"""The LM transformer (`repro_torch.models.transformer`) against
`repro.models.transformer` for all five LM archs at `conftest.reduced_lm`
sizes (2 layers, d 64, 4 heads of 16, d_ff 96, vocab 256, at most 8
experts top-2), on the CPU.

`repro`'s parameters (seed 0) carry across through numpy, in f32 and in
bf16, and numpy token batches from a seed go to both; `repro` runs under
`jax.jit`, as its steps do. Covered: `param_defs` (shapes and counts, at
full size too), `loss`, `prefill` through the dense and the KV-chunked
attention, `decode` from a prefilled cache (at the cache's last position
too), `loss` gradients, the C2 sparse decode, C5 int8 `{"q","s"}` weights
laid out as `repro.launch.cells._int8_lm_defs` lays them (per out-channel
scales for the layer stacks, per-row for the tables; norms, biases and MoE
experts stay float), `pad_vocab`, and `remat` on against off.

Tolerances, relative to the largest |value| of `repro`'s (logits, or a
gradient leaf; the loss relative to itself):
- f32: 1e-5 (measured up to 1.1e-6 on logits, 2.2e-6 on gradients);
- bf16: 3e-2 on logits and 1e-3 on the loss (measured up to 1.05e-2 and
  2.6e-4), 4e-2 on each gradient leaf (measured up to 2.4e-2). `repro`
  scans its layers compiled, and XLA's fusions round bf16 intermediates in
  other places than its `jnp` code does, op by op, where the port is
  bit-equal to it (`tests/test_torch_lm_layers.py`, `tests/test_torch_moe.py`);
  over two layers those one-step differences grow to these. For OLMoE's
  bf16 gradients they flip a router choice (jitted `repro` and the port
  part by 0.30 on `moe/w_up`), so that case is held against `repro` run op
  by op (`jax.disable_jit`), through its plain dispatcher (the eager
  shard_map of the EP one takes over two minutes): 1.7e-2 measured.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401
from conftest import reduced_lm  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro.models.common import param_count as jax_param_count  # noqa: E402
from repro_torch.configs.base import LMConfig, get_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    from_numpy_tree, param_count, tree_leaves)

LM_ARCHS = ["command_r_35b", "chatglm3_6b", "yi_6b", "olmoe_1b_7b",
            "llama4_maverick_400b_a17b"]
TOL = {"float32": {"logits": 1e-5, "loss": 1e-5, "grad": 1e-5},
       "bfloat16": {"logits": 3e-2, "loss": 1e-3, "grad": 4e-2}}
B, S, T_CACHE = 2, 32, 48


def _pair(arch, **over):
    jcfg = reduced_lm(arch, **over)
    return jcfg, LMConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    jcfg, _ = _pair(arch, dtype=dtype)
    return init_params(jtf.param_defs(jcfg), jax.random.key(0))


def _port(jparams):
    return from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(ref, got):
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _jax_run(jcfg, jp, batch, lm_rules, with_loss=True):
    """`repro`'s loss, prefill and a decode step at position S from the
    prefilled cache in a cache of T_CACHE, all jitted."""
    loss = jax.jit(lambda p, b: jtf.loss(p, b, jcfg, lm_rules)[0])(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}) if with_loss else None
    logits, (k, v) = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, lm_rules))(
        jp, jnp.asarray(batch["tokens"]))
    kc = jnp.zeros(jtf.cache_shape(jcfg, B, T_CACHE), k.dtype).at[:, :, :S].set(k)
    vc = jnp.zeros(jtf.cache_shape(jcfg, B, T_CACHE), v.dtype).at[:, :, :S].set(v)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    pos = jnp.full((B,), S, jnp.int32)
    dlogits, (kc2, _) = jax.jit(lambda p, c, t, q: jtf.decode(p, c, t, q, jcfg, lm_rules))(
        jp, (kc, vc), tok, pos)
    return loss, logits, k, dlogits, kc2, np.array(tok)


def _port_run(tcfg, tp, batch, tok, with_loss=True):
    loss = ttf.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)[0] \
        if with_loss else None
    with torch.no_grad():
        logits, (k, v) = ttf.prefill(tp, torch.from_numpy(batch["tokens"]), tcfg)
        kc = torch.zeros(ttf.cache_shape(tcfg, B, T_CACHE), dtype=k.dtype)
        vc = torch.zeros(ttf.cache_shape(tcfg, B, T_CACHE), dtype=v.dtype)
        kc[:, :, :S], vc[:, :, :S] = k, v
        cache = (kc.clone(), vc.clone())
        dlogits, (kc2, _) = ttf.decode(tp, cache, torch.from_numpy(tok),
                                       torch.full((B,), S, dtype=torch.int32), tcfg)
    assert torch.equal(cache[0], kc) and torch.equal(cache[1], vc)  # decode is functional
    return loss, logits, k, dlogits, kc2


def _check_all(ref, got, dtype):
    tol = TOL[dtype]
    if ref[0] is not None:
        assert abs(float(ref[0]) - float(got[0])) <= tol["loss"] * abs(float(ref[0]))
    assert _rel(ref[1], got[1]) <= tol["logits"]
    assert _rel(ref[3], got[3]) <= tol["logits"]
    if dtype == "float32":
        assert _rel(ref[2], got[2]) <= tol["logits"] and _rel(ref[4], got[4]) <= tol["logits"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_defs_match_repro_at_full_size(arch):
    jdefs = jtf.param_defs(jax_get_config(arch))
    cfg = get_config(arch)
    tdefs = ttf.param_defs(cfg)
    jleaves = jax.tree.leaves_with_path(jdefs, is_leaf=lambda d: hasattr(d, "axes"))
    tleaves = list(tree_leaves(tdefs))
    assert [tuple(getattr(k, "key", k) for k in p) for p, _ in jleaves] == [p for p, _ in tleaves]
    assert all(j.shape == t.shape for (_, j), (_, t) in zip(jleaves, tleaves))
    assert param_count(tdefs) == jax_param_count(jdefs)
    jcfg = jax_get_config(arch)  # the analytic counts (command_r's counts a norm it has not)
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (jcfg.param_count(), jcfg.active_param_count())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_prefill_and_decode_match_repro(arch, dtype, lm_rules):
    jcfg, tcfg = _pair(arch, dtype=dtype)
    jp = _params(arch, dtype)
    batch = _batch(jcfg.vocab_size)
    ref = _jax_run(jcfg, jp, batch, lm_rules)
    got = _port_run(tcfg, _port(jp), batch, ref[5])
    assert got[1].dtype == torch.float32 and got[2].dtype == _port(jp)["embed"].dtype
    _check_all(ref, got, dtype)


def _grad_case(arch, dtype, lm_rules, op_by_op=False, **over):
    jcfg, tcfg = _pair(arch, dtype=dtype, **over)
    jp = _params(arch, dtype)
    batch = _batch(jcfg.vocab_size, seed=1)
    grad = jax.grad(lambda p, b: jtf.loss(p, b, jcfg, lm_rules)[0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if op_by_op:
        with jax.disable_jit():
            jg = grad(jp, jbatch)
    else:
        jg = jax.jit(grad)(jp, jbatch)
    tp = _port(jp)
    paths, leaves = zip(*tree_leaves(tp))
    live = [x.requires_grad_(True) for x in leaves]
    loss, _ = ttf.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, live)
    ref = dict(zip(paths, (g for _, g in tree_leaves(jax.tree.map(np.asarray, jg)))))
    for path, g in zip(paths, grads):
        assert g.dtype == live[paths.index(path)].dtype
        assert _rel(ref[path], g) <= TOL[dtype]["grad"], path


@pytest.mark.parametrize("arch,dtype", [(a, d) for d in ("float32", "bfloat16") for a in LM_ARCHS
                                        if (a, d) != ("olmoe_1b_7b", "bfloat16")])
def test_loss_gradients_match_jax_grad(arch, dtype, lm_rules):
    _grad_case(arch, dtype, lm_rules)


def test_moe_bf16_loss_gradients_match_repros_op_by_op(lm_rules):
    _grad_case("olmoe_1b_7b", "bfloat16", lm_rules, op_by_op=True, moe_impl="gspmd")


@pytest.mark.parametrize("arch", ["yi_6b", "olmoe_1b_7b", "llama4_maverick_400b_a17b"])
def test_chunked_prefill_over_several_kv_chunks(arch, lm_rules):
    """q_chunk 8 over S = 32: the streaming softmax's four steps in each
    layer's prefill and loss."""
    jcfg, tcfg = _pair(arch, dtype="float32", q_chunk=8, attn_impl="chunked")
    jp = _params(arch, "float32")
    batch = _batch(jcfg.vocab_size, seed=2)
    ref = _jax_run(jcfg, jp, batch, lm_rules)
    _check_all(ref, _port_run(tcfg, _port(jp), batch, ref[5]), "float32")


@pytest.mark.parametrize("window,n_global", [(8, 4), (16, 64), (4096, 1024)])
@pytest.mark.parametrize("arch", ["yi_6b", "chatglm3_6b", "olmoe_1b_7b"])
def test_sparse_attention_decode_matches_repro(arch, window, n_global, lm_rules):
    """C2 at decode: a window below the position (globals outside it
    count), and the config's default one over the whole cache, where it is
    the dense decode."""
    jcfg, tcfg = _pair(arch, dtype="float32", sparse_attention=True, attn_window=window,
                       attn_n_global=n_global)
    jp = _params(arch, "float32")
    batch = _batch(jcfg.vocab_size, seed=3)
    ref = _jax_run(jcfg, jp, batch, lm_rules)
    got = _port_run(tcfg, _port(jp), batch, ref[5])
    _check_all(ref, got, "float32")
    if window >= T_CACHE:
        dense = _port_run(dataclasses.replace(tcfg, sparse_attention=False), _port(jp), batch,
                          ref[5])
        assert torch.equal(dense[3], got[3])


def _int8(jparams):
    """C5 int8 reps in numpy, `cells._int8_lm_defs`'s layout: every float
    weight of 2+ dims outside the MoE experts and the norms -> {"q": int8,
    "s": f32}; per-row scales [V] for embed / lm_head, per (layer,
    out-channel) [L, dout] for the stacks."""
    def visit(path, a):
        a = np.asarray(a, np.float32)
        keys = [getattr(k, "key", str(k)) for k in path]
        name = keys[-1]
        if a.ndim < 2 or "moe" in keys or "norm" in name or name.startswith("b"):
            return np.asarray(a)
        axis = 1 if name in ("embed", "lm_head") else a.ndim - 2
        s = np.max(np.abs(a), axis=axis) / 127.0
        s = np.maximum(s, 1e-12).astype(np.float32)
        q = np.clip(np.round(a / np.expand_dims(s, axis)), -127, 127).astype(np.int8)
        return {"q": q, "s": s}

    return jax.tree_util.tree_map_with_path(visit, jparams)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_int8_weights_match_repro(arch, lm_rules):
    """The serve path, prefill and decode; `loss` takes no int8 table in
    either package (its chunked CE reads the table's shape). Against
    `repro` run op by op: its `_mm` rounds the dequantized weight to bf16,
    and under `jax.jit` XLA drops that f32 -> bf16 -> f32 round trip (the
    port and jitted `repro` part by 3.3e-3 to 8.5e-3, op by op by 1.1e-6
    at most). MoE archs take the plain dispatcher, whose eager run is
    quick (the experts stay float)."""
    jcfg, tcfg = _pair(arch, dtype="float32", moe_impl="gspmd")
    np_params = _int8(_params(arch, "float32"))
    jp = jax.tree.map(jnp.asarray, np_params)
    assert isinstance(np_params["embed"], dict) and np_params["embed"]["s"].ndim == 1
    assert np_params["attn"]["wq"]["s"].shape == (jcfg.n_layers, jcfg.n_heads * 16)
    batch = _batch(jcfg.vocab_size, seed=4)
    with jax.disable_jit():
        ref = _jax_run(jcfg, jp, batch, lm_rules, with_loss=False)
    tp = from_numpy_tree(np_params, "cpu")
    assert tp["attn"]["wq"]["q"].dtype == torch.int8
    _check_all(ref, _port_run(tcfg, tp, batch, ref[5], with_loss=False), "float32")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "yi_6b"])
def test_pad_vocab_matches_repro(arch, lm_rules):
    """vocab 256 padded to 512 rows in both tables; labels stay < 256."""
    jcfg, tcfg = _pair(arch, dtype="float32", pad_vocab=True)
    jp = init_params(jtf.param_defs(jcfg), jax.random.key(0))
    assert jp["embed"].shape[0] == 512 and ttf.param_defs(tcfg)["embed"].shape[0] == 512
    batch = _batch(jcfg.vocab_size, seed=5)
    ref = _jax_run(jcfg, jp, batch, lm_rules)
    _check_all(ref, _port_run(tcfg, _port(jp), batch, ref[5]), "float32")


@pytest.mark.parametrize("arch", ["yi_6b", "llama4_maverick_400b_a17b"])
def test_decode_at_the_caches_last_position(arch, lm_rules):
    """pos = T - 1 writes the cache's last row; both packages agree."""
    jcfg, tcfg = _pair(arch, dtype="float32")
    jp = _params(arch, "float32")
    tok = np.array([3, 7], np.int32)
    pos = np.full((B,), T_CACHE - 1, np.int32)
    rng = np.random.default_rng(6)
    kc, vc = (rng.normal(size=jtf.cache_shape(jcfg, B, T_CACHE)).astype(np.float32)
              for _ in range(2))
    ref, (rk, _) = jax.jit(lambda p, c, t, q: jtf.decode(p, c, t, q, jcfg, lm_rules))(
        jp, (jnp.asarray(kc), jnp.asarray(vc)), jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        got, (gk, _) = ttf.decode(_port(jp), (torch.from_numpy(kc), torch.from_numpy(vc)),
                                  torch.from_numpy(tok), torch.from_numpy(pos), tcfg)
    assert _rel(ref, got) <= TOL["float32"]["logits"] and _rel(rk, gk) <= 1e-5
    assert np.array_equal(_f32(gk)[:, :, :-1], kc[:, :, :-1])


@pytest.mark.parametrize("arch", ["yi_6b", "chatglm3_6b", "command_r_35b", "olmoe_1b_7b"])
def test_decode_equals_the_last_position_of_a_longer_prefill(arch):
    """Prefill S - 1 tokens, decode token S - 1 at position S - 1: the
    logits of a prefill of all S tokens at its last position (f32). For
    the MoE arch at a capacity factor where neither dispatcher drops: at
    1.25 the prefill's per-expert capacity drops entries that decode's
    two-token dispatch keeps (0.89 apart here)."""
    _, tcfg = _pair(arch, dtype="float32", capacity_factor=8.0)
    tp = _port(_params(arch, "float32"))
    toks = torch.from_numpy(_batch(tcfg.vocab_size, seed=7)["tokens"])
    with torch.no_grad():
        full, _ = ttf.prefill(tp, toks, tcfg)
        _, (k, v) = ttf.prefill(tp, toks[:, :-1], tcfg)
        kc = torch.zeros(ttf.cache_shape(tcfg, B, S), dtype=k.dtype)
        vc = torch.zeros_like(kc)
        kc[:, :, :S - 1], vc[:, :, :S - 1] = k, v
        step, _ = ttf.decode(tp, (kc, vc), toks[:, -1], torch.full((B,), S - 1), tcfg)
    assert _rel(full, step) <= TOL["float32"]["logits"]


@pytest.mark.parametrize("arch", ["yi_6b", "olmoe_1b_7b", "llama4_maverick_400b_a17b"])
def test_remat_changes_no_number(arch):
    out = []
    for remat in (False, True):
        _, tcfg = _pair(arch, dtype="float32", remat=remat, flash_remat=remat, q_chunk=16)
        tp = _port(_params(arch, "float32"))
        paths, leaves = zip(*tree_leaves(tp))
        live = [x.requires_grad_(True) for x in leaves]
        batch = _batch(tcfg.vocab_size, seed=8)
        loss, _ = ttf.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        out.append([loss.detach()] + list(torch.autograd.grad(loss, live)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_moe_prefill_records_its_dispatch_drops_and_decode_its_own():
    _, tcfg = _pair("olmoe_1b_7b", dtype="float32", capacity_factor=0.5)
    tp = _port(_params("olmoe_1b_7b", "float32"))
    toks = torch.from_numpy(_batch(tcfg.vocab_size, seed=9)["tokens"])
    stats = {}
    with torch.no_grad():
        logits, (k, v) = ttf.prefill(tp, toks, tcfg, stats)
        plain, _ = ttf.prefill(tp, toks, tcfg)
    assert torch.equal(logits, plain)  # a record, not an input
    assert sorted(stats) == ["dropped_expert", "dropped_pair"]
    assert len(stats["dropped_pair"]) == len(stats["dropped_expert"]) == tcfg.n_layers
    T = B * S * tcfg.top_k
    assert all(int(n) == T - max(4, int(np.ceil(T * 0.5))) for n in stats["dropped_pair"])
    stats = {}
    with torch.no_grad():
        ttf.decode(tp, (k, v), toks[:, 0], torch.full((B,), S - 1), tcfg, stats)
    assert sorted(stats) == ["dropped", "experts"] and len(stats["experts"]) == tcfg.n_layers
    assert all(1 <= int(n) <= B * tcfg.top_k for n in stats["experts"])
