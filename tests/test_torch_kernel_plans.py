"""The launch plans of the FM interaction and int8 matmul kernels
(`kernels/fm_interaction/fm_interaction.launch_plan`,
`kernels/int8_matmul/int8_matmul.launch_plan`): pure functions of the
shape that the CUDA entries take as they are. Each covers every example,
or every tile of out and its K range, exactly once; stays within the
shared memory its kernel takes; puts FM's serve call and the benchmark's
512³ in one wave of the H100's 132 SMs; and plans no 16-byte copy of
int8 rows that 16 does not divide. The kernels themselves, and their
copies at every alignment, run in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

from repro_torch.kernels.fm_interaction import fm_interaction as fm  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul as i8  # noqa: E402

SMS = 132  # the H100's
SM_SMEM = 233_472  # an SM's shared memory on Hopper (228 KB), all its blocks together
F_K = [(1, 1), (3, 10), (39, 10), (40, 2000), (60_000, 1)]  # F·k 1, 30, 390, 80,000 (> 227 KB)
INT8_SHAPES = [(51200, 64, 256), (512, 512, 512), (512, 208, 200), (513, 300, 129), (1, 1, 1),
               (37, 1001, 65), (100, 64, 256)]  # chip_smoke.py's, and the card tests' edge


def _fm_chunks(plan, B):
    """(first example, examples) of each block of a plan."""
    return [(x * plan.examples, min(plan.examples, B - x * plan.examples))
            for x in range(plan.blocks)]


@pytest.mark.parametrize("F,k", F_K)
@pytest.mark.parametrize("B", [1, 37, 512, 65_536])
def test_fm_plan_covers_every_example_once(B, F, k):
    plan = fm.launch_plan(B, F, k, SMS)
    assert plan == fm.launch_plan(B, F, k, SMS)  # a pure function of the shape
    covered = [0] * B
    for first, n in _fm_chunks(plan, B):
        assert n >= 1  # no block without an example
        for b in range(first, first + n):
            covered[b] += 1
    assert covered == [1] * B
    # a column's row groups: f = r, r + R, ... partition the F rows
    rows = sorted(f for r in range(plan.rows) for f in range(r, F, plan.rows))
    assert rows == list(range(F)) and 1 <= plan.rows <= F
    if plan.wide:
        # one example with its partial sums is more than a block's shared memory
        assert not fm.fits(1, F, k)
        assert plan.examples == 1 and plan.blocks == B
        assert plan.rows == 1 or plan.rows * k <= fm.THREADS
    else:
        assert fm.staged_smem_bytes(plan.examples, F, k, plan.rows) <= fm.MAX_SMEM_BYTES
        # the E·R·k partial sums keep the threads busy, or R is as large as F allows
        assert plan.examples * plan.rows * k <= max(fm.THREADS, plan.examples * k)
        assert plan.rows == F or plan.examples * (plan.rows + 1) * k > fm.THREADS
    assert (F * k * 4 > 227 * 1024) == bool(plan.wide)


def test_fm_plan_at_fm_serve_call_is_one_wave():
    """B = 512, F = 39, k = 10: the fewest examples a block that put the
    batch in one wave, 4 a block in 128 blocks, 3 row groups."""
    plan = fm.launch_plan(512, 39, 10, SMS)
    assert (plan.wide, plan.examples, plan.rows, plan.blocks) == (0, 4, 3, 128)
    assert plan.blocks <= SMS < -(-512 // (plan.examples - 1))


@pytest.mark.parametrize("F,k", [(39, 10), (3, 10), (26, 16)])
def test_fm_plan_at_a_large_batch_fills_chunks_to_the_chunk_bytes(F, k):
    """B = 65,536: as many examples a chunk as CHUNK_BYTES hold (10 at
    F·k = 390), many blocks an SM each with its whole chunk in flight."""
    plan = fm.launch_plan(65_536, F, k, SMS)
    ex_bytes = 4 * F * k
    assert plan.examples * ex_bytes <= fm.CHUNK_BYTES < (plan.examples + 1) * ex_bytes
    assert SM_SMEM // fm.staged_smem_bytes(plan.examples, F, k, plan.rows) >= 8
    if (F, k) == (39, 10):
        assert (plan.examples, plan.blocks) == (10, 6554)


@pytest.mark.parametrize("B,F,k", [(0, 39, 10), (4, 0, 10), (4, 39, 0)])
def test_fm_plan_refuses_empty_shapes(B, F, k):
    with pytest.raises(ValueError):
        fm.launch_plan(B, F, k, SMS)


@pytest.mark.parametrize("case", ["blocks", "smem", "wide_rows", "wide_examples"])
def test_fm_forced_plan_the_c_entry_would_refuse_raises(case):
    B, F, k = 37, 39, 10
    plan = {"blocks": fm.chunk_plan(B, F, k, 4)._replace(blocks=9),
            "smem": fm.chunk_plan(B, F, k, 200),
            "wide_rows": fm.wide_plan(B, F, k)._replace(rows=39),
            "wide_examples": fm.wide_plan(B, F, k)._replace(examples=2)}[case]
    with pytest.raises(ValueError):
        fm._check_plan(plan, B, F, k)
    fm._check_plan(fm.launch_plan(B, F, k), B, F, k)
    fm._check_plan(fm.wide_plan(B, F, k), B, F, k)


def _int8_tiles(plan, M):
    """(M tile, N tile) of each block's walk, in the order the blocks walk."""
    tiles_m = i8.m_tiles(M, plan.tile)
    return [(mt, y) for x in range(plan.grid_m) for y in range(plan.grid_n)
            for mt in range(x, tiles_m, plan.grid_m)]


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_plan_covers_every_tile_and_k_range_once(M, K, N):
    plan = i8.launch_plan(M, K, N, SMS)
    assert plan == i8.launch_plan(M, K, N, SMS)  # a pure function of the shape
    shape = i8.TILES[plan.tile]
    tiles = _int8_tiles(plan, M)
    want = {(mt, y) for mt in range(-(-M // shape.bm)) for y in range(-(-N // shape.bn))}
    assert len(tiles) == len(set(tiles)) and set(tiles) == want
    assert plan.grid_n <= i8.MAX_GRID_N
    # (each tile takes all of K in the block that owns it: the plan splits no K)
    # no more blocks than the SMs hold at once, and no block without a tile
    assert plan.blocks <= max(SMS * shape.per_sm, plan.grid_n)
    assert plan.grid_m <= i8.m_tiles(M, plan.tile)
    # the blocks an SM holds fit in its threads
    assert shape.threads * shape.per_sm <= 2048
    # the wide tile wherever it gives a wave of tiles, else the small one
    wide_tiles = i8.m_tiles(M, i8.WIDE) * -(-N // i8.TILES[i8.WIDE].bn)
    assert plan.tile == (i8.WIDE if wide_tiles >= SMS else i8.SMALL)


def test_int8_plan_at_the_rankers_ffn_reads_a_q_once():
    """51,200 x 64 x 256: the 64 x 256 tile spans N, so a block's tiles
    read disjoint rows of a_q; 2 blocks an SM walk the 800 tiles."""
    plan = i8.launch_plan(51200, 64, 256, SMS)
    assert (plan.tile, plan.grid_n, plan.grid_m) == (i8.WIDE, 1, 2 * SMS)
    assert i8.TILES[i8.WIDE].bn == 256 and (plan.va, plan.vb) == (16, 16)


def test_int8_plan_at_512_cubed_is_one_wave():
    """512³: the 32 x 64 tile, 128 blocks of one tile each, one wave."""
    plan = i8.launch_plan(512, 512, 512, SMS)
    assert (plan.tile, plan.grid_m, plan.grid_n, plan.blocks) == (i8.SMALL, 16, 8, 128)
    assert plan.blocks <= SMS


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_plan_copies_16_bytes_only_where_16_divides_the_rows(M, K, N):
    """The copy widths are the widest of 16, 4 and 1 bytes that divide K
    (a_q's rows) and N (b_q's), so with a base aligned to them every
    row of a_q and b_q starts aligned in memory."""
    plan = i8.launch_plan(M, K, N, SMS)
    for v, row in ((plan.va, K), (plan.vb, N)):
        assert v in (16, 4, 1) and row % v == 0
        assert v == 16 or row % (4 * v) != 0  # the widest that divides the row


@pytest.mark.parametrize("offset,width", [(0, 16), (1, 1), (4, 4), (8, 4), (16, 16)])
def test_int8_load_widths_drop_to_the_base_alignment(offset, width):
    """A view that starts `offset` bytes into a 64-byte-aligned allocation
    takes the widest copy its base allows, at most the plan's."""
    base = torch.zeros(4096, dtype=torch.int8)
    shift = (-base.data_ptr()) % 64
    a = base[shift + offset:shift + offset + 64 * 32].view(64, 32)
    b = base[shift:shift + 32 * 48].view(32, 48)
    plan = i8.launch_plan(64, 32, 48, SMS)
    assert i8.load_widths(plan, a, b) == (width, 16)


@pytest.mark.parametrize("M,K,N,tile,grid_m", [(0, 4, 4, None, None), (4, 4, 0, None, None),
                                               (64, 64, 64, 2, None), (64, 64, 64, 1, 3),
                                               (64, 64, 64, 0, 0)])
def test_int8_plan_refuses_what_the_kernel_does_not_take(M, K, N, tile, grid_m):
    with pytest.raises(ValueError):
        if tile is None:
            i8.launch_plan(M, K, N, SMS)
        else:
            i8.tile_plan(M, K, N, tile, grid_m)
