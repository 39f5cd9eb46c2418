"""`repro_torch.distributed.grad_compression` against
`repro.distributed.grad_compression`, on the CPU.

- `repro`'s two tests (`tests/test_training.py`), run on the port on one
  rank (no process group: the collective is the identity, as `repro`'s
  psum over no axes).
- 4 gloo ranks against `compress_psum_mean` under shard_map on 4 forced CPU
  devices (one `repro` subprocess; the pytest process never sets
  `XLA_FLAGS`), over 5 error-feedback steps of per-rank gradients made with
  numpy from a seed: the mean and the residuals within 1e-6 of the largest
  |value| of `repro`'s (measured: the mean within 1.2e-7, the residuals
  equal); the codes' all-reduced sums are whole numbers and equal the
  ranks' codes summed in numpy, exactly. The reference runs its shard_map
  op by op: under `jax.jit` XLA contracts `g - codes * scale` into a fused
  multiply-add, and the residual, a rounding error of g, then moves by an
  ulp of g (3.9e-5 of the largest residual here).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.distributed import grad_compression as gc  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

WORLD, STEPS, TOL = 4, 5, 1e-6
SHAPES = {"a": (300,), "b": (4, 320), "c": (2, 3, 256)}

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.grad_compression import init_residuals, make_compressed_allreduce
from repro.distributed.sharding import shard_map_compat
from repro.launch.mesh import compat_make_mesh

data = dict(np.load(sys.argv[1]))
steps, world = int(sys.argv[3]), int(sys.argv[4])
mesh = compat_make_mesh((world,), ("data",))
names = sorted({k.split("/")[1] for k in data})
fn = make_compressed_allreduce(("data",))

def body(g, r):  # blocks [1, ...]: one rank's leaf
    m, r2 = fn({k: v[0] for k, v in g.items()}, {k: v[0] for k, v in r.items()})
    return ({k: v[None] for k, v in m.items()}, {k: v[None] for k, v in r2.items()})

spec = {k: P("data") for k in names}
step = shard_map_compat(body, mesh=mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec))  # op by op: no fused multiply-adds
res = {k: jnp.zeros(data[f"0/{k}"].shape, jnp.float32) for k in names}
out = {}
for t in range(steps):
    means, res = step({k: jnp.asarray(data[f"{t}/{k}"]) for k in names}, res)
    out.update({f"{t}/mean/{k}": np.asarray(v) for k, v in means.items()})
    out.update({f"{t}/res/{k}": np.asarray(v) for k, v in res.items()})
np.savez(sys.argv[2], **out)
"""


def test_grad_compression_error_feedback_unbiased():
    """On a constant gradient, error feedback makes the time-averaged
    compressed gradient converge to the true one (`repro`'s test)."""
    g = torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), (300,)) * 3.0))
    res = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    steps = 50
    for _ in range(steps):
        mean, res = gc.compress_allreduce_mean(g, res)  # no group: one rank
        acc = acc + mean
    np.testing.assert_allclose(acc / steps, g, rtol=2e-2, atol=2e-2)


def test_grad_compression_tree_api():
    grads = {"a": torch.ones(10), "b": {"c": torch.full((5,), 2.0)}}
    res = gc.init_residuals(grads)
    means, new_res = gc.make_compressed_allreduce()(grads, res)
    assert [p for p, _ in tree_leaves(means)] == [p for p, _ in tree_leaves(grads)]
    assert [p for p, _ in tree_leaves(new_res)] == [p for p, _ in tree_leaves(grads)]
    # single step error bounded by quantization granularity
    np.testing.assert_allclose(means["a"], grads["a"], rtol=0.02, atol=0.02)


def test_one_rank_matches_repros_compress_psum_mean_to_the_bit():
    from repro.distributed.grad_compression import compress_psum_mean

    rng = np.random.default_rng(3)
    g, r = (rng.standard_normal((5, 300)).astype(np.float32) for _ in range(2))
    mean, res = compress_psum_mean(jnp.asarray(g), jnp.asarray(r), ())
    tmean, tres = gc.compress_allreduce_mean(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(np.asarray(mean), tmean.numpy())
    np.testing.assert_array_equal(np.asarray(res), tres.numpy())


def test_allreduce_bytes_are_an_f32_all_reduce_of_the_padded_blocks():
    assert gc.allreduce_bytes(torch.empty(300)) == 4 * (512 + 2)
    assert gc.allreduce_bytes(torch.empty(4, 256)) == 4 * (1024 + 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    grads = [{k: (rng.standard_normal((WORLD,) + s) * (1 + t)).astype(np.float32)
              for k, s in SHAPES.items()} for t in range(STEPS)]
    np.savez(tmp / "grads.npz", **{f"{t}/{k}": v for t, g in enumerate(grads)
                                   for k, v in g.items()})
    ref = torch_ranks.Reference(_REFERENCE, [tmp / "grads.npz", tmp / "ref.npz", STEPS, WORLD],
                                WORLD)
    try:
        ranks = torch_ranks.run_ranks(torch_ranks.compression_rank, WORLD, tmp, grads, STEPS)
        ref.wait()
    finally:
        ref.kill()
    return dict(np.load(tmp / "ref.npz")), ranks


@pytest.mark.parametrize("step", range(STEPS))
def test_four_gloo_ranks_match_repro_under_shard_map(step, runs):
    ref, ranks = runs
    errs = {}
    for name in SHAPES:
        for part in ("mean", "res"):
            full = ref[f"{step}/{part}/{name}"]  # [WORLD, ...]
            scale = max(float(np.max(np.abs(full))), 1e-30)
            errs[f"{part}/{name}"] = max(
                float(np.max(np.abs(full[r] - ranks[r][step][part][name]))) / scale
                for r in range(WORLD))
        sums = [ranks[r][step]["code_sums"][name] for r in range(WORLD)]
        codes = np.sum([ranks[r][step]["codes"][name] for r in range(WORLD)], axis=0,
                       dtype=np.float64)
        for s in sums:
            np.testing.assert_array_equal(s, np.round(s))
            np.testing.assert_array_equal(s.astype(np.float64), codes)
    print(json.dumps({"step": step, **errs}))
    assert max(errs.values()) <= TOL, errs
