"""The launch plan of the whole-iteration kernels, on the CPU.

``ops.iteration_cuda.plan_iteration`` chooses how ``csrc/iteration.cu``
launches: threads per block, contiguous wavelengths per thread (the
sweeps' block shape), the depth of the per-thread ``cp.async`` ring (1,
or 0 where shared memory is short), the rows each ring slot stages (the
stale flux row, then both table rows of each staged species) and the
dynamic shared-memory bytes, which the kernels check against their own
layout.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest

pytest.importorskip("torch")

from frei_tpu_torch.ops import iteration_cuda as ic  # noqa: E402
from frei_tpu_torch.ops import sweep_cuda as sc  # noqa: E402


def _a16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("W, npt, threads", [
    (1, 1, 32), (33, 1, 64), (256, 2, 128), (257, 4, 96), (500, 4, 128),
    (512, 4, 128), (513, 8, 96), (1000, 8, 128), (2048, 8, 256)])
@pytest.mark.parametrize("elem", [4, 8], ids=["float32", "float64"])
def test_block_shape_is_the_sweeps(W, npt, threads, elem):
    """Wavelengths per thread: the smallest power of two up to 8 that
    leaves at most 128 threads (256 at 8); a whole number of warps
    covering W, as ``plan_sweep``."""
    plan = ic.plan_iteration(W, 30, 1, elem)
    assert (plan.npt, plan.threads) == (npt, threads)
    assert plan.threads * plan.npt >= W
    assert (plan.npt, plan.threads) == sc._block_shape(W)


@pytest.mark.parametrize("W, npt, threads", [
    (1, 1, 32), (33, 1, 64), (256, 1, 256), (257, 2, 160), (500, 2, 256),
    (512, 2, 256), (513, 4, 160), (1000, 4, 256), (1025, 8, 160),
    (2048, 8, 256)])
@pytest.mark.parametrize("elem", [4, 8], ids=["float32", "float64"])
def test_loop_block_shape(W, npt, threads, elem):
    """The loop kernel's blocks: the smallest power of two up to 8 that
    leaves at most 256 threads, a whole number of warps covering W."""
    plan = ic.plan_iteration(W, 30, 1, elem, loop=True)
    assert (plan.npt, plan.threads) == (npt, threads)
    assert plan.threads * plan.npt >= W


def test_headline_loop_plan():
    """The headline loop (W 500, L 30, one species, float32): 256 threads
    of 2 wavelengths, the same ring rows, 8 warps' partials."""
    plan = ic.plan_iteration(500, 30, 1, 4, loop=True)
    assert plan == ic.IterationPlan(threads=256, npt=2, depth=1, rows=3,
                                    smem=plan.smem)
    assert plan.smem == ic.iteration_smem_bytes(30, 1, 4, 256, 2, 1, 3)
    assert plan.smem - ic.plan_iteration(500, 30, 1, 4).smem == _a16(
        (3 * 29 + 1) * 8 * 4) - _a16((3 * 29 + 1) * 4 * 4)


def test_headline_plan_and_layout():
    """The headline (W 500, L 30, one species, float32) stages the stale
    flux row and both table rows one layer ahead in 128-thread blocks of
    4 wavelengths; the bytes are the kernel's layout, section by section
    16-byte aligned."""
    plan = ic.plan_iteration(500, 30, 1, 4)
    assert plan == ic.IterationPlan(threads=128, npt=4, depth=1, rows=3,
                                    smem=plan.smem)
    want = (_a16((3 * 29 + 1) * 4 * 4)       # per-warp partials
            + _a16(4 * 29 * 4)               # block quadratures
            + _a16(9 * 30 * 4)               # per-layer vectors
            + _a16(2 * 29 * 4)               # dtf, both orderings
            + _a16(30 * 1 * 4)               # mixing ratios
            + _a16(3 * 30 * 4)               # kidx, flips, conv
            + _a16(2 * 3 * 512 * 4))         # the ring
    assert plan.smem == want == 15984


@pytest.mark.parametrize("W", [1, 33, 500, 512, 513, 1000, 2048])
@pytest.mark.parametrize("L", [3, 30])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("elem", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("loop", [False, True], ids=["iteration", "loop"])
def test_plan_fits_and_matches_layout(W, L, S, elem, loop):
    """Every plan stages at most S species, stays under the shared-memory
    target unless it is the flux-row-only ring at depth 0, fits the
    card, and its bytes are ``iteration_smem_bytes`` of its own fields."""
    plan = ic.plan_iteration(W, L, S, elem, loop=loop)
    assert plan.depth in (0, 1)
    assert plan.rows % 2 == 1 and (plan.rows - 1) // 2 <= S
    assert plan.smem <= sc.SMEM_TARGET or (plan.depth, plan.rows) == (0, 1)
    assert plan.smem <= sc.SMEM_LIMIT
    assert plan.smem == ic.iteration_smem_bytes(
        L, S, elem, plan.threads, plan.npt, plan.depth, plan.rows)
    # a plan stages every species whenever that fits the target
    full = ic.iteration_smem_bytes(L, S, elem, plan.threads, plan.npt, 1,
                                   1 + 2 * S)
    assert (plan.depth, plan.rows) == (1, 1 + 2 * S) or full > sc.SMEM_TARGET


@pytest.mark.parametrize("W, L, S, elem, depth, rows", [
    (500, 30, 1, 4, 1, 3),       # the headline: everything staged
    (500, 30, 2, 4, 1, 5),       # two species staged
    (500, 30, 2, 8, 1, 3),       # float64: one of two species staged
    (513, 30, 1, 8, 1, 1),       # float64, 8 per thread: flux row only
    (2048, 30, 1, 4, 1, 1),      # 256 threads: flux row only
    (2048, 30, 1, 8, 0, 1),      # float64 at 2048: depth 0
    (2048, 30, 2, 8, 0, 1)])
def test_plan_shrinks_to_fit(W, L, S, elem, depth, rows):
    """Short of shared memory the plan stages fewer species (the rest are
    read from L2), then only the flux row, then drops to ring depth 0."""
    plan = ic.plan_iteration(W, L, S, elem)
    assert (plan.depth, plan.rows) == (depth, rows)


def test_plan_options_and_refusal():
    """More layers and species than shared memory holds, and rows past
    2048 wavelengths, are refused."""
    with pytest.raises(ValueError, match="shared memory"):
        ic.plan_iteration(500, 300, 80, 8)
    with pytest.raises(ValueError, match="block shape"):
        ic.plan_iteration(2049, 30, 1, 4)

