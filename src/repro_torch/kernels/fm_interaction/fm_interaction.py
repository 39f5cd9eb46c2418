"""ctypes binding of the Hopper FM interaction kernel (`csrc/fm_interaction.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/fm_interaction/fm_interaction.py:fm_interaction_kernel`. The
caller (`ops.fm_interaction_op`) has checked device, dtype, shape and
contiguity; this module picks the launch plan (`launch_plan`), allocates
the output and launches on the current stream. The library is built at
first use, never at import.

The plan is a pure function of (B, F, k, SMs): a block of THREADS
threads takes a chunk of `examples` consecutive examples, copies all of
it into shared memory at once and reduces it there; an example too wide
for shared memory takes the kernel's `wide` branch, a block an example
reading e directly. The C entry lays out shared memory and issues the
copies; the plan only needs to know what fits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_pruned_matmul.block_pruned_matmul import H100_SMS, sm_count

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

MAX_SMEM_BYTES = 232_448  # a block's shared memory on Hopper (sm_90)
CHUNK_BYTES = 16_384  # bytes of e a staged chunk holds at most, unless one example is larger
THREADS = 128  # threads a block (kThreads in the CUDA source)


class Plan(NamedTuple):
    wide: int      # 1: the wide branch (an example a block, e read directly); 0: staged chunks
    examples: int  # examples a chunk (1 when wide)
    rows: int      # row groups R: a column's sum over f split into R strided parts
    blocks: int    # blocks in the grid: a chunk (staged) or up to an example (wide) each


def staged_smem_bytes(E: int, F: int, k: int, R: int) -> int:
    """Shared memory the C entry gives a staged block, which it refuses over
    MAX_SMEM_BYTES: the chunk and up to 3 floats of alignment before it,
    rounded up to 16 bytes, and the partial sums of e and e² [E, R, k]."""
    return 4 * ((E * F * k + 6) // 4 * 4 + 2 * E * R * k)


def launch_plan(B: int, F: int, k: int, sms: int = H100_SMS) -> Plan:
    """The kernel's launch for e [B, F, k], a pure function of the shape.

    Staged: `examples` E the fewest that put B in one wave of `sms` blocks
    (4 at B = 512), but at most CHUNK_BYTES of e a chunk (10 examples at
    F·k = 390), so that a large B keeps many blocks an SM, each with its
    whole chunk in flight; R row groups so that the E·R·k partial sums
    keep THREADS busy; a block a chunk. Wide, where one example and its
    partial sums do not fit in shared memory: a block an example, B
    blocks; R = THREADS // k row groups where k <= THREADS / 2.
    """
    if min(B, F, k, sms) < 1:
        raise ValueError(f"need B, F, k and sms of at least 1, got {B}, {F}, {k}, {sms}")
    if fits(1, F, k):
        E = max(1, min(-(-B // sms), CHUNK_BYTES // (4 * F * k)))
        while not fits(E, F, k):
            E -= 1  # one example over CHUNK_BYTES: E is 1 and fits, as checked above
        return chunk_plan(B, F, k, E)
    return wide_plan(B, F, k)


def _rows(E: int, F: int, k: int) -> int:
    """Row groups that keep THREADS busy with E·k columns: at least 1, at most F."""
    return max(1, min(F, THREADS // (E * k)))


def fits(E: int, F: int, k: int) -> bool:
    """Whether a staged chunk of E examples fits in a block's shared memory."""
    return staged_smem_bytes(E, F, k, _rows(E, F, k)) <= MAX_SMEM_BYTES


def chunk_plan(B: int, F: int, k: int, examples: int) -> Plan:
    """The staged kernel's launch with `examples` examples a chunk."""
    return Plan(0, examples, _rows(examples, F, k), -(-B // examples))


def wide_plan(B: int, F: int, k: int) -> Plan:
    """The wide branch's launch: a block an example, its R·k partial sums of
    e and e² in shared memory where R > 1."""
    return Plan(1, 1, _rows(1, F, k), B)


def _check_plan(plan: Plan, B: int, F: int, k: int) -> None:
    """Refuse a forced launch the C entry would refuse."""
    ok = 1 <= plan.rows <= F and plan.blocks >= 1 and plan.examples >= 1
    if plan.wide:
        ok = ok and plan.examples == 1 and plan.blocks == B \
            and (plan.rows == 1 or plan.rows * k <= THREADS)
    else:
        ok = ok and plan.blocks == -(-B // plan.examples) \
            and staged_smem_bytes(plan.examples, F, k, plan.rows) <= MAX_SMEM_BYTES
    if not ok:
        raise ValueError(f"no such launch at B={B}, F={F}, k={k}: {plan}")


def fm_interaction(e: torch.Tensor, plan: Optional[Plan] = None) -> torch.Tensor:
    """e: f32 [B, F, k], contiguous on the current CUDA device -> f32 [B].
    `plan` None takes `launch_plan` at the card's SM count; a given plan
    forces a launch (the card-only tests and chip_smoke.py time others)."""
    B, F, k = e.shape
    if plan is None:
        plan = launch_plan(B, F, k, sm_count(e.device))
    else:
        _check_plan(plan, B, F, k)
    out = torch.empty((B,), dtype=torch.float32, device=e.device)
    err = _build.function("fm_interaction", "fm_interaction_f32", _ARGTYPES)(
        e.data_ptr(), out.data_ptr(), B, F, k, plan.wide, plan.examples, plan.rows, plan.blocks,
        torch.cuda.current_stream(e.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fm_interaction kernel launch failed: cudaError {err}")
    return out
