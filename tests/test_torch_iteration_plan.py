"""The launch plan of the whole-iteration kernels, on the CPU.

``ops.iteration_cuda.plan_iteration`` chooses how ``csrc/iteration.cu``
launches: threads per block, contiguous wavelengths per thread (the
sweeps' block shape), the depth of the per-thread ``cp.async`` ring (1,
or 0 where shared memory is short), the rows each ring slot stages (the
stale flux row, then both table rows of each staged species) and the
dynamic shared-memory bytes, which the kernels check against their own
layout.  The ring is sized by the blocks per SM the card holds: here a
model of an H100's occupancy calculator (:func:`h100_blocks`) stands in
for the card's answer, and without one the plan keeps to
``SMEM_TARGET``.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest

pytest.importorskip("torch")

from frei_tpu_torch.ops import iteration_cuda as ic  # noqa: E402
from frei_tpu_torch.ops import sweep_cuda as sc  # noqa: E402


def _a16(n):
    return -(-n // 16) * 16


#: registers a thread of each instantiation, (elem, loop, npt) -> count,
#: from ptxas's report for sm_90a
REGISTERS = {
    (4, False, 1): 72, (4, False, 2): 72, (4, False, 4): 72,
    (4, False, 8): 204, (8, False, 1): 124, (8, False, 2): 176,
    (8, False, 4): 223, (8, False, 8): 255, (4, True, 1): 80,
    (4, True, 2): 80, (4, True, 4): 80, (4, True, 8): 186,
    (8, True, 1): 156, (8, True, 2): 174, (8, True, 4): 207,
    (8, True, 8): 252}


def h100_blocks(elem, loop):
    """A model of ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for
    one kernel on an H100: four register files of 16,384 an SM, each
    warp's registers in one of them, allocated in units of 256; 228 KB
    of shared memory an SM, allocated in units of 128 bytes plus 1 KB
    reserved a block; 2,048 threads and 32 blocks an SM.  Returns
    ``blocks(threads, npt, smem)``."""
    def blocks(threads, npt, smem):
        warp_regs = -(-REGISTERS[elem, loop, npt] * 32 // 256) * 256
        by_regs = 4 * (16384 // warp_regs) // (threads // 32)
        by_smem = 228 * 1024 // (-(-smem // 128) * 128 + 1024)
        return min(by_regs, by_smem, 2048 // threads, 32)
    return blocks


def _plan(W, L, S, elem, loop=False):
    """The plan under the H100 model, and the model's blocks of a plan."""
    model = h100_blocks(elem, loop)
    plan = ic.plan_iteration(W, L, S, elem, loop=loop, blocks_per_sm=model)
    return plan, lambda p: model(p.threads, p.npt, p.smem)


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
    """Every plan stages at most S species, fits the card, and its bytes
    are ``iteration_smem_bytes`` of its own fields.  Under the H100 model
    it keeps the blocks per SM of the flux row alone at depth 1 and
    stages every species whenever that keeps them; without a card it
    stays under the shared-memory target unless it is the flux-row-only
    ring at depth 0, and stages every species whenever that fits it."""
    plan, blocks = _plan(W, L, S, elem, loop)
    target = ic.plan_iteration(W, L, S, elem, loop=loop)
    for p in (plan, target):
        assert p.depth in (0, 1)
        assert p.rows % 2 == 1 and (p.rows - 1) // 2 <= S
        assert p.smem <= sc.SMEM_LIMIT
        assert p.smem == ic.iteration_smem_bytes(
            L, S, elem, p.threads, p.npt, p.depth, p.rows)
        assert (p.threads, p.npt) == (plan.threads, plan.npt)

    def at(depth, rows):
        return plan._replace(depth=depth, rows=rows,
                             smem=ic.iteration_smem_bytes(
                                 L, S, elem, plan.threads, plan.npt, depth,
                                 rows))
    flux_row, full = at(1, 1), at(1, 1 + 2 * S)
    assert plan.depth == 1 and blocks(plan) >= blocks(flux_row)
    assert plan == full or blocks(full) < blocks(flux_row)
    assert target.smem <= sc.SMEM_TARGET or (
        target.depth, target.rows) == (0, 1)
    assert target == full or full.smem > sc.SMEM_TARGET


@pytest.mark.parametrize("W, L, S, elem, depth, rows", [
    (500, 30, 1, 4, 1, 3),       # the headline: everything staged
    (500, 30, 2, 4, 1, 5),       # two species staged
    (500, 30, 2, 8, 1, 5),       # float64: both species, 2 blocks an SM
    (513, 30, 1, 8, 1, 3),       # float64, 8 per thread: 2 blocks an SM
    (2048, 30, 1, 4, 1, 3),      # 256 threads: one block an SM either way
    (2048, 30, 1, 8, 1, 3),      # float64 at 2048: 106 KB, one block
    (2048, 30, 2, 8, 1, 5),      # 170 KB
    (2048, 30, 4, 8, 1, 5),      # 7 or 9 rows would pass the card's 227 KB
    (500, 30, 4, 4, 1, 5),       # float32: 7 or 9 rows would cost a block
    (1000, 30, 4, 8, 1, 5),      # float64: 7 rows would cost a block
    (2048, 580, 4, 8, 0, 1)])    # no depth-1 ring fits the card: depth 0
def test_plan_shrinks_to_fit(W, L, S, elem, depth, rows):
    """Where staging every species would cost blocks per SM, or not fit
    the card, the plan stages fewer species (the rest are read from L2),
    then only the flux row, then drops to ring depth 0."""
    plan, _ = _plan(W, L, S, elem)
    assert (plan.depth, plan.rows) == (depth, rows)


@pytest.mark.parametrize("W, L, S, elem, depth, rows", [
    (500, 30, 1, 4, 1, 3),       # the headline: everything staged
    (500, 30, 2, 4, 1, 5),       # two species staged
    (500, 30, 2, 8, 1, 3),       # float64: one of two species staged
    (513, 30, 1, 8, 1, 1),       # float64, 8 per thread: flux row only
    (2048, 30, 1, 4, 1, 1),      # 256 threads: flux row only
    (2048, 30, 1, 8, 0, 1),      # float64 at 2048: depth 0
    (2048, 30, 2, 8, 0, 1)])
def test_plan_without_a_card_keeps_the_target(W, L, S, elem, depth, rows):
    """With no card to answer, the ring keeps to ``SMEM_TARGET``: fewer
    species, then only the flux row, then ring depth 0."""
    plan = ic.plan_iteration(W, L, S, elem)
    assert (plan.depth, plan.rows) == (depth, rows)


@pytest.mark.parametrize("S, elem, loop, plan, blocks", [
    # the four-species float64 loop: every species staged, one block
    (4, 8, True, ic.IterationPlan(256, 2, 1, 9, 84240), 1),
    # one species in float64: the launch it had under the target
    (1, 8, True, ic.IterationPlan(256, 2, 1, 3, 34368), 1),
    # four species in float32 (80 registers): every species, 3 blocks
    (4, 4, True, ic.IterationPlan(256, 2, 1, 9, 42320), 3),
    # the float32 iteration kernel (72 registers, 7 blocks): every species
    # would leave 5, so two are staged
    (4, 4, False, ic.IterationPlan(128, 4, 1, 5, 24528), 7)])
def test_plan_keeps_the_blocks_of_the_flux_row(S, elem, loop, plan, blocks):
    """At 500 bins x 30 layers the ring stages the most species whose
    shared memory leaves as many blocks per SM as the flux row alone."""
    got, count = _plan(500, 30, S, elem, loop)
    assert got == plan
    assert count(got) == blocks == count(got._replace(
        rows=1, smem=ic.iteration_smem_bytes(30, S, elem, got.threads,
                                             got.npt, 1, 1)))


def test_plan_asks_the_card_for_its_own_kernel():
    """The occupancy is asked for the plan's own block shape, at each
    candidate's bytes, from the most species down."""
    asked = []

    def blocks(threads, npt, smem):
        asked.append((threads, npt, smem))
        return 1 if smem < 60000 else 0
    plan = ic.plan_iteration(500, 30, 4, 8, loop=True, blocks_per_sm=blocks)
    assert (plan.depth, plan.rows) == (1, 5)
    assert {a[:2] for a in asked} == {(256, 2)}
    sizes = [ic.iteration_smem_bytes(30, 4, 8, 256, 2, 1, r)
             for r in (1, 9, 7, 5)]
    assert [a[2] for a in asked] == sizes


def test_plan_options_and_refusal():
    """More layers and species than shared memory holds, and rows past
    2048 wavelengths, are refused."""
    with pytest.raises(ValueError, match="shared memory"):
        ic.plan_iteration(500, 300, 80, 8)
    with pytest.raises(ValueError, match="block shape"):
        ic.plan_iteration(2049, 30, 1, 4)

