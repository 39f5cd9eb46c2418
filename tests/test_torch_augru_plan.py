"""The AUGRU kernel's launch plan (`kernels/augru/augru.launch_plan`), a
pure function of (B, g, SMs) that the CUDA entry takes as it is: every
batch row in exactly one block, each block within the shared memory and
the registers the plan claims, and one wave of blocks wherever it says so.
The kernel itself runs in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

from repro_torch.kernels.augru.augru import (  # noqa: E402
    KS_SIZES, MAX_G, MAX_ROWS, MAX_SMEM_BYTES, SM_REGISTERS, SPLIT, UNITS_PER_WARP, launch_plan,
    smem_bytes,
)

SMS = 132  # the H100's


@pytest.mark.parametrize("g", [1, 18, 108, 136])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 131, 132, 133, 512, 4096])
def test_plan_covers_every_row_once_within_its_budget(B, g):
    plan = launch_plan(B, g, SMS)
    rows, blocks = plan.rows, plan.blocks
    starts = [i * rows for i in range(blocks)]
    covered = [0] * B
    for s in starts:
        for b in range(s, min(s + rows, B)):
            covered[b] += 1
    assert covered == [1] * B and starts[-1] < B  # no row twice, no block empty
    assert rows % 4 == 0 and 4 <= rows <= MAX_ROWS
    # lanes: 8 units of SPLIT lanes a warp, every unit of g owned
    assert plan.threads == 32 * -(-g // UNITS_PER_WARP) <= 1024
    assert plan.threads // 32 * UNITS_PER_WARP >= g
    # the smallest template instance whose lane groups cover g
    assert plan.ks in KS_SIZES and SPLIT * plan.ks >= g
    assert all(SPLIT * n < g for n in KS_SIZES if n < plan.ks)
    assert plan.smem == smem_bytes(rows, g, plan.ks) <= MAX_SMEM_BYTES
    # wh's 3*ks floats and 12 sums a lane, within the registers a thread may
    # have with one block of these threads an SM
    assert plan.regs == 3 * plan.ks + 12 <= plan.reg_budget <= min(255, SM_REGISTERS // plan.threads)
    assert plan.waves == -(-blocks // SMS)
    # one wave wherever the rows a block may grow to (shared memory and
    # MAX_ROWS) hold the batch in SMS blocks
    cap = max(r for r in range(4, MAX_ROWS + 1, 4) if smem_bytes(r, g, plan.ks) <= MAX_SMEM_BYTES)
    if B <= SMS * cap:
        assert plan.waves == 1 and blocks <= SMS
    # the least rows that give one wave: fewer rows a block, less a step
    if plan.waves == 1 and rows > 4:
        assert -(-B // (rows - 4)) > SMS


@pytest.mark.parametrize("B,rows,blocks", [(512, 4, 128), (4096, 32, 128), (37, 4, 10),
                                           (1, 4, 1), (133, 4, 34)])
def test_plan_at_dien_shapes(B, rows, blocks):
    """DIEN's g = 108: 4 rows a block at B = 512, 32 at the benchmark's
    4096, both 128 blocks in one wave on 132 SMs; 14 warps of 8 units."""
    plan = launch_plan(B, 108, SMS)
    assert (plan.rows, plan.blocks, plan.waves, plan.threads, plan.ks) == (rows, blocks, 1, 448, 27)


@pytest.mark.parametrize("B,g", [(0, 8), (4, 0), (4, MAX_G + 1)])
def test_plan_refuses_what_the_kernel_does_not_take(B, g):
    with pytest.raises(ValueError):
        launch_plan(B, g, SMS)
