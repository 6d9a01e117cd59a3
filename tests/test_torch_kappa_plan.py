"""The kappa lookup kernel's plan, on the CPU.

``csrc/kappa.cu`` groups the lookup points by their (T, P) cell before
it reads the table: each point's axis weights and bucket key (the cell
i nP + j, or M = nT nP outside the hull), the buckets counted and
scanned, the points sorted by bucket, and one block per work item (one
bucket and up to ``ITEM_POINTS`` of its points) reading its cell's
corner rows once.  Here the plan's plain twin (``kappa_plan_plain``,
with ``_work_items``, the kernel's decoding of a block's work item) is
pinned: every point in exactly one work item, one key
per item, no item over the limit, the outside points in bucket M; and
the gather twin evaluated in plan order and scattered back is the lookup
bit for bit, and matches the JAX package's ``kappa_from_stack`` and its
TPU kernel in interpret mode (float64, rtol 1e-12).  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 3c, which holds the CUDA plan against this twin).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu.opacity.tables as jtab  # noqa: E402
from frei_tpu_torch.opacity import tables as ttab  # noqa: E402
from frei_tpu_torch.ops import kappa_cuda as KC  # noqa: E402

W = 11   # odd: no 16-byte pieces

# (T axis, P axis [bar]) of the stacks; cases below choose the points
_T = np.array([500.0, 1000.0, 1800.0, 2500.0, 3000.0])
_P = np.array([1e-5, 1e-3, 1e-1, 10.0])


def _stack(n_p, n_species=2, seed=3):
    rng = np.random.RandomState(seed)
    P = _P[:n_p]
    names = ("1H2-16O", "12C-16O", "1H-12C-14N")[:n_species]
    tabs = {iso: (rng.rand(5, n_p, W) * (k + 1) + 0.1, _T, P)
            for k, iso in enumerate(names)}
    return tabs, ttab.make_opacity_stack(tabs, dtype=torch.float64,
                                         device="cpu")


def _points(case, rng):
    """Lookup temperatures and pressures [barye] of one case."""
    Pc = _P * 1e6
    if case == "spread":          # random, some outside in T and P
        T = rng.uniform(300.0, 3300.0, (6, 40))
        P = np.tile(10.0 ** rng.uniform(-0.5, 7.5, 40), (6, 1))
        T[0, :3] = [3000.0, 500.0, 500.0 * (1 - 4 * np.finfo(float).eps)]
    elif case == "one-cell":      # N >> ITEM_POINTS, all in one cell
        T = rng.uniform(1000.0, 1800.0, (7, 50))
        P = rng.uniform(Pc[1], Pc[2], (7, 50))
    elif case == "distinct":      # every point in its own cell
        i, j = np.meshgrid(np.arange(4), np.arange(3), indexing="ij")
        T = 0.5 * (_T[i] + _T[i + 1])
        P = np.sqrt(Pc[j] * Pc[j + 1])
    elif case == "outside":       # every point outside the hull
        T = rng.uniform(3100.0, 4000.0, (3, 9))
        P = np.full((3, 9), Pc[1])
        P[:, ::2] = 1e9
        T[:, ::2] = 1000.0
    elif case == "empty":
        T = np.zeros((0, 4))
        P = np.zeros((0, 4))
    else:                         # "single-P": the one P point, T spread
        T = rng.uniform(400.0, 3100.0, (5, 30))
        P = np.full((5, 30), Pc[0])
    return T, P


_CASES = ["spread", "one-cell", "distinct", "outside", "empty", "single-P"]


def _work_items(plan, item_points=KC.ITEM_POINTS):
    """Each work item as the kernel's block decodes it: ``(bucket, start,
    stop)``, int64 tensors of the item count, the item's points being
    ``plan.order[start:stop]``."""
    item_off = plan.item_offsets.long()
    off = plan.offsets.long()
    k = torch.arange(int(item_off[-1]))
    bucket = torch.searchsorted(item_off[:-1], k, right=True) - 1
    start = off[bucket] + (k - item_off[bucket]) * item_points
    stop = torch.minimum(start + item_points, off[bucket + 1])
    return bucket, start, stop


def _case(case, n_species=2):
    rng = np.random.RandomState(_CASES.index(case))
    tabs, stack = _stack(1 if case == "single-P" else 4, n_species)
    T, P = _points(case, rng)
    mmr = rng.uniform(1e-5, 1e-3, (n_species,) + T.shape)
    sig = np.linspace(1e-3, 2e-3, W)
    return tabs, stack, T, P, mmr, sig


@pytest.mark.parametrize("item_points", [1, 7, 64])
@pytest.mark.parametrize("case", _CASES)
def test_plan_puts_every_point_in_one_work_item(case, item_points):
    """Work items partition the points: each point in exactly one item,
    one key per item, at most ``item_points`` points an item, items of a
    bucket full but the last; outside points (and only they) in bucket M;
    keys, fractions and the hull as ``_axis_weights`` gives them."""
    _, stack, T, P, _, _ = _case(case)
    nT, nP = stack.values.shape[1:3]
    M = nT * nP
    plan = KC.kappa_plan_plain(stack, torch.tensor(T), torch.tensor(P),
                               item_points)
    N = T.size
    assert plan.key.dtype == plan.order.dtype == torch.int32
    assert plan.offsets.shape == plan.item_offsets.shape == (M + 2,)
    assert int(plan.offsets[-1]) == N
    bucket, start, stop = _work_items(plan, item_points)
    assert bucket.numel() == int(plan.item_offsets[-1])
    counts = torch.diff(plan.offsets.long())
    assert torch.equal(torch.diff(plan.item_offsets.long()),
                       (counts + item_points - 1) // item_points)
    seen = torch.zeros(N, dtype=torch.long)
    for b, s, e in zip(bucket.tolist(), start.tolist(), stop.tolist()):
        assert 0 < e - s <= item_points
        ids = plan.order[s:e].long()
        seen[ids] += 1
        assert (plan.key[ids] == b).all()
        assert e == int(plan.offsets[b + 1]) or e - s == item_points
    assert (seen == 1).all()
    # keys against the axis weights, point by point
    ti, tf, t_ok = ttab._axis_weights(stack.temps, torch.tensor(T).ravel())
    pj, pf, p_ok = ttab._axis_weights(stack.press_cgs,
                                      torch.tensor(P).ravel())
    ok = t_ok & p_ok
    assert torch.equal(plan.key.long(), torch.where(ok, ti * nP + pj, M))
    assert torch.equal(plan.frac, torch.stack([tf, pf], 1))
    if case == "outside":
        assert (plan.key == M).all() and bucket.unique().tolist() == [M]
    if case == "one-cell":
        assert N > 4 * item_points and bucket.unique().numel() == 1
    if case == "distinct":
        assert plan.key.unique().numel() == N and (counts[:M] <= 1).all()
    if case == "spread":
        assert ok[2] and not ok.all() and ok.any()   # 4 ULP below the edge


@pytest.mark.parametrize("n_species", [1, 2, 3])
@pytest.mark.parametrize("case", _CASES)
def test_plan_order_gives_the_lookup_bit_for_bit(case, n_species):
    """The gather twin evaluated in plan order, one work item at a time,
    and scattered back to the points' own rows, is ``kappa_plain`` bit
    for bit: the plan moves points, not arithmetic.  Outside points carry
    sigma alone."""
    _, stack, T, P, mmr, sig = _case(case, n_species)
    args = [torch.tensor(x) for x in (mmr, T, P, sig)]
    want, _ = KC.kappa_plain(stack, *args)
    plan = KC.kappa_plan_plain(stack, args[1], args[2])
    S = stack.values.shape[0]
    m, t, p = (args[0].reshape(S, -1), args[1].reshape(-1),
               args[2].reshape(-1))
    got = torch.full((t.numel(), W), float("nan"), dtype=torch.float64)
    for _, s, e in zip(*_work_items(plan)):
        ids = plan.order[s:e].long()
        got[ids] = KC.kappa_plain(stack, m[:, ids], t[ids], p[ids],
                                  args[3])[0]
    assert torch.equal(got.reshape(want.shape), want)
    outside = (plan.key == stack.values.shape[1] * stack.values.shape[2])
    assert torch.equal(got[outside], args[3].expand(int(outside.sum()), W))


@pytest.mark.parametrize("case", ["spread", "single-P", "one-cell"])
def test_planned_lookup_matches_jax_and_pallas_interpret(case):
    """The lookup in plan order against the JAX package's gather
    ``kappa_from_stack`` and its TPU kernel ``kappa_pallas`` in interpret
    mode, float64, rtol 1e-12 (the same blend; the TPU kernel contracts a
    one-hot tile, another order of the same sums)."""
    from frei_tpu.ops.kappa_pallas import kappa_pallas
    tabs, stack, T, P, mmr, sig = _case(case)
    jst = jtab.make_opacity_stack(tabs, dtype=jnp.float64)
    jargs = [jnp.asarray(x) for x in (mmr, T, P, sig)]
    jtab.set_interp_mode("gather")
    try:
        want, _ = jtab.kappa_from_stack(jst, *jargs)
    finally:
        jtab.set_interp_mode(None)
    pallas, _ = kappa_pallas(jst, *jargs, interpret=True)
    args = [torch.tensor(x) for x in (mmr, T, P, sig)]
    plan = KC.kappa_plan_plain(stack, args[1], args[2])
    order = plan.order.long()
    S = stack.values.shape[0]
    rows, _ = KC.kappa_plain(stack, args[0].reshape(S, -1)[:, order],
                             args[1].reshape(-1)[order],
                             args[2].reshape(-1)[order], args[3])
    got = torch.empty_like(rows)
    got[order] = rows
    got = got.reshape(T.shape + (W,)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-12)


def test_kernel_runs_the_twin_on_the_cpu():
    """On CPU tensors the wrapper runs the twin and counts nothing."""
    _, stack, T, P, mmr, sig = _case("spread")
    args = [torch.tensor(x) for x in (mmr, T, P, sig)]
    n0 = KC.kappa_kernel.launches
    assert torch.equal(KC.kappa_kernel(stack, *args)[0],
                       KC.kappa_plain(stack, *args)[0])
    assert KC.kappa_kernel.launches == n0
