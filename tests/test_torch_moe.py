"""The MoE dispatchers (`repro_torch.models.moe.moe_ffn` and the one-group
`repro_torch.distributed.expert_parallel.moe_ffn_ep`) against `repro`'s
under `lm_rules` on its one-device test mesh, on the CPU.

`repro`'s parameters and numpy inputs from a seed go to both. The router's
inputs are normal draws: no two of a token's expert probabilities tie at
the top-k boundary (checked below), so `torch.topk` and `lax.top_k` pick
the same experts whatever their tie-breaking.

Tolerances, on the largest |Δ| over the largest |value| of `repro`'s:
- f32 outputs, aux and gradients: 1e-5 (measured up to 3e-7 here);
- bf16 outputs: 2^-8, one bf16 step at the largest output, against
  `repro` executed op by op, as its `jnp` code reads (measured 0 here, aux
  within 1.2e-7). Under `jax.jit` XLA fuses the router's bf16 product into
  its f32 convert and rounds elsewhere: the port then differs by 4.2e-3 to
  8.4e-3 on these inputs (seeds 0-2), and on seed 2 at (E, K) = (8, 2) a
  near tie in the router flips an expert (1.7e-1). The transformer tests,
  whose reference scans its layers compiled, hold bf16 to that measure.
At a capacity factor that drops entries, the port drops the entries
`repro` drops: the count, worked out from `repro`'s own routing with its
stable sort, is the port's, and a different choice would move a dropped
token's output by O(1).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401
from repro.configs.base import LMConfig as JaxLMConfig  # noqa: E402
from repro.distributed.expert_parallel import moe_ffn_ep as jax_moe_ffn_ep  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.moe import moe_param_defs as jax_moe_param_defs  # noqa: E402
from repro_torch.configs.base import LMConfig  # noqa: E402
from repro_torch.distributed import expert_parallel  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import from_numpy_tree, param_count  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0**-8
CASES = [(8, 1), (8, 2), (4, 4)]


def _setup(E=8, K=2, cf=8.0, D=32, F=64, shared=0, dtype="float32", seed=0):
    kw = dict(name="m", family="lm", n_layers=2, d_model=D, n_heads=4, n_kv_heads=2, d_ff=F,
              vocab_size=64, n_experts=E, top_k=K, capacity_factor=cf,
              n_shared_experts=shared, dtype=dtype)
    jcfg, tcfg = JaxLMConfig(**kw), LMConfig(**kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = init_params(jax_moe_param_defs(jcfg, 1, jdt), jax.random.key(seed))
    lp = jax.tree.map(lambda a: a[0], params)
    x = np.asarray(jax.random.normal(jax.random.key(seed + 1), (2, 16, D)).astype(jdt))
    return jcfg, tcfg, lp, x


def _port(lp, x):
    return from_numpy_tree(jax.tree.map(np.asarray, lp), "cpu"), \
        from_numpy_tree({"x": x}, "cpu")["x"]


def _err(ref, got):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert ref.shape == got.shape
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _routing(lp, x, K):
    """`repro`'s expert ids [T, K] for these inputs; asserts that no two
    probabilities tie at the top-k boundary."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, lp["router"]).astype(jnp.float32), -1)
    ordered = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    if K < ordered.shape[1]:
        assert np.all(ordered[:, K - 1] > ordered[:, K])
    return np.asarray(jax.lax.top_k(probs, K)[1])


def _dropped(keys, n_bins, capacity):
    """Entries a stable sort by key drops past `capacity` per bin."""
    return int(sum(max(0, int(np.sum(keys == b)) - capacity) for b in range(n_bins)))


def test_param_defs_match_repros_shapes():
    jcfg, tcfg, _, _ = _setup(shared=1)
    jdefs = jax_moe_param_defs(jcfg, 3, jnp.float32)
    tdefs = moe.moe_param_defs(tcfg, 3, torch.float32)
    assert sorted(jdefs) == sorted(tdefs)
    assert all(jdefs[k].shape == tdefs[k].shape for k in jdefs)
    assert param_count(tdefs) == sum(int(np.prod(d.shape)) for d in jdefs.values())


@pytest.mark.parametrize("n,e,k,f", [(1024, 8, 2, 1.25), (8, 64, 1, 1.0), (100, 8, 8, 0.5)])
def test_capacity_formulas(n, e, k, f):
    from repro.distributed.expert_parallel import _capacity
    from repro.models.moe import capacity

    assert moe.capacity(n, e, k, f) == capacity(n, e, k, f)
    assert expert_parallel._capacity(n, e, f) == _capacity(n, e, f)


@pytest.mark.parametrize("E,K", CASES)
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_matches_repro(E, K, shared):
    jcfg, tcfg, lp, x = _setup(E=E, K=K, shared=shared)
    _routing(lp, x, K)
    out, aux = jax_moe_ffn(jnp.asarray(x), lp, jcfg)
    tp, tx = _port(lp, x)
    tout, taux = moe.moe_ffn(tx, tp, tcfg)
    assert _err(out, tout) <= F32_TOL and _err(aux, taux) <= F32_TOL


@pytest.mark.parametrize("E,K", CASES)
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_ep_matches_repro_on_its_test_mesh(E, K, shared, lm_rules):
    jcfg, tcfg, lp, x = _setup(E=E, K=K, shared=shared)
    _routing(lp, x, K)
    out, aux = jax.jit(lambda x, lp: jax_moe_ffn_ep(x, lp, jcfg, lm_rules))(jnp.asarray(x), lp)
    tp, tx = _port(lp, x)
    tout, taux = expert_parallel.moe_ffn_ep(tx, tp, tcfg)
    assert _err(out, tout) <= F32_TOL and _err(aux, taux) <= F32_TOL


@pytest.mark.parametrize("E,K", CASES)
@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_moe_ffn_drops_the_entries_repro_drops(E, K, cf):
    jcfg, tcfg, lp, x = _setup(E=E, K=K, cf=cf)
    eidx = _routing(lp, x, K)
    T = x.shape[0] * x.shape[1]
    C = moe.capacity(T, E, K, cf)
    expect = _dropped(eidx.reshape(-1), E, C)
    out, aux = jax_moe_ffn(jnp.asarray(x), lp, jcfg)
    tp, tx = _port(lp, x)
    stats = {}
    tout, taux = moe.moe_ffn(tx, tp, tcfg, stats)
    assert int(stats["dropped"][0]) == expect
    assert int(stats["experts"][0]) == len(np.unique(eidx))
    assert _err(out, tout) <= F32_TOL and _err(aux, taux) <= F32_TOL


@pytest.mark.parametrize("E,K", CASES)
@pytest.mark.parametrize("cf", [0.25, 0.5, 0.9])
def test_moe_ffn_ep_drops_the_entries_repro_drops_at_both_stages(E, K, cf, lm_rules):
    """Stage 1 keeps the first C_pair of the token-major entries (one
    group); stage 2 the first C_e of those per expert."""
    jcfg, tcfg, lp, x = _setup(E=E, K=K, cf=cf)
    eidx = _routing(lp, x, K).reshape(-1)
    T = x.shape[0] * x.shape[1]
    c_pair = expert_parallel._capacity(T * K, 1, cf)
    c_e = expert_parallel._capacity(c_pair, E, cf)
    expect_pair = max(0, T * K - c_pair)
    expect_expert = _dropped(eidx[:c_pair], E, c_e)
    assert expect_pair + expect_expert > 0
    out, aux = jax.jit(lambda x, lp: jax_moe_ffn_ep(x, lp, jcfg, lm_rules))(jnp.asarray(x), lp)
    tp, tx = _port(lp, x)
    stats = {}
    tout, taux = expert_parallel.moe_ffn_ep(tx, tp, tcfg, stats)
    assert (int(stats["dropped_pair"][0]), int(stats["dropped_expert"][0])) == \
        (expect_pair, expect_expert)
    assert _err(out, tout) <= F32_TOL and _err(aux, taux) <= F32_TOL


def test_the_two_dispatchers_drop_differently_at_a_small_capacity(lm_rules):
    """Decode's `moe_ffn` (C = max(8, ⌈K·T/E·cf⌉)) and prefill's one-group
    EP path (C_pair, then C_e) keep different entries, in both packages."""
    jcfg, tcfg, lp, x = _setup(E=8, K=2, cf=0.5)
    tp, tx = _port(lp, x)
    a, _ = moe.moe_ffn(tx, tp, tcfg)
    b, _ = expert_parallel.moe_ffn_ep(tx, tp, tcfg)
    ja, _ = jax_moe_ffn(jnp.asarray(x), lp, jcfg)
    jb, _ = jax.jit(lambda x, lp: jax_moe_ffn_ep(x, lp, jcfg, lm_rules))(jnp.asarray(x), lp)
    assert _err(ja, b) > 0.1 and _err(jb, a) > 0.1
    assert _err(ja, a) <= F32_TOL and _err(jb, b) <= F32_TOL


@pytest.mark.parametrize("dispatcher,E,K", [("moe_ffn", 8, 1), ("moe_ffn", 8, 2),
                                             ("moe_ffn", 4, 4), ("moe_ffn_ep", 8, 2)])
def test_bf16_outputs_match_repros_op_by_op(dispatcher, E, K, lm_rules):
    """Against `repro` run op by op (not under `jax.jit`), which is what
    its `jnp` code says; see the module's docstring."""
    jcfg, tcfg, lp, x = _setup(E=E, K=K, dtype="bfloat16")
    _routing(lp, x, K)
    tp, tx = _port(lp, x)
    if dispatcher == "moe_ffn":
        out, aux = jax_moe_ffn(jnp.asarray(x), lp, jcfg)
        tout, taux = moe.moe_ffn(tx, tp, tcfg)
    else:
        out, aux = jax_moe_ffn_ep(jnp.asarray(x), lp, jcfg, lm_rules)
        tout, taux = expert_parallel.moe_ffn_ep(tx, tp, tcfg)
    assert tout.dtype == torch.bfloat16
    assert _err(out, tout) <= BF16_TOL and _err(aux, taux) <= F32_TOL


@pytest.mark.parametrize("dispatcher", ["moe_ffn", "moe_ffn_ep"])
@pytest.mark.parametrize("E,K,cf", [(8, 2, 8.0), (8, 2, 0.5), (4, 4, 1.25)])
def test_gradients_match_jax_grad(dispatcher, E, K, cf, lm_rules):
    """d/d(x, params) of sum(out²) + aux, dropped entries included."""
    jcfg, tcfg, lp, x = _setup(E=E, K=K, cf=cf, shared=1)
    _routing(lp, x, K)
    jfn = {"moe_ffn": lambda x, lp: jax_moe_ffn(x, lp, jcfg),
           "moe_ffn_ep": lambda x, lp: jax_moe_ffn_ep(x, lp, jcfg, lm_rules)}[dispatcher]
    tfn = {"moe_ffn": lambda x, lp: moe.moe_ffn(x, lp, tcfg),
           "moe_ffn_ep": lambda x, lp: expert_parallel.moe_ffn_ep(x, lp, tcfg)}[dispatcher]

    def objective(x, lp):
        out, aux = jfn(x, lp)
        return jnp.sum(out**2) + aux

    gx, gp = jax.jit(jax.grad(objective, argnums=(0, 1)))(jnp.asarray(x), lp)
    tp, tx = _port(lp, x)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    out, aux = tfn(tx, leaves)
    grads = torch.autograd.grad(torch.sum(out**2) + aux, [tx] + [leaves[k] for k in sorted(gp)])
    assert _err(gx, grads[0]) <= F32_TOL
    for k, g in zip(sorted(gp), grads[1:]):
        assert _err(gp[k], g) <= F32_TOL, k


def test_config_defaults_keep_the_ep_dispatcher_for_train_and_prefill():
    cfg = LMConfig(name="m", family="lm", n_layers=2, d_model=8, n_heads=2, n_kv_heads=2,
                   d_ff=8, vocab_size=8)
    assert cfg.moe_impl == "ep" and dataclasses.replace(cfg, moe_impl="gspmd").moe_impl == "gspmd"
