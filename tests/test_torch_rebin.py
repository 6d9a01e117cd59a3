"""The resort-rebin of frei_tpu_torch against frei_tpu and a loop
transcription of the reference's numba Trapz semantics
(`frei/interp.py:174-194`), case for case with tests/test_rebin.py, plus
the rebin plan, the kernel wrapper's plain path and the host C++ engine.

Tolerances: float64 twin against the loop oracle and JAX
``resort_rebin`` at rtol 1e-12 (the same panels, summed in another
order); against JAX ``resort_rebin_pallas`` (a float32 kernel) at rtol
1e-5 / atol 1e-7, as the JAX package holds that kernel; the host engine
bit-identical to the JAX package's (the same C++ source)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu.native import grouped_trapezoid_native as j_native  # noqa: E402
from frei_tpu.ops import rebin as jrebin  # noqa: E402
from frei_tpu.ops.rebin_pallas import resort_rebin_pallas  # noqa: E402
from frei_tpu_torch.native import (grouped_trapezoid_native,  # noqa: E402
                                   native_available)
from frei_tpu_torch.ops import rebin as trebin  # noqa: E402
from frei_tpu_torch.ops import rebin_cuda as RC  # noqa: E402

torch.set_num_threads(2)


def trapz_in_bins_oracle(values, x, edges):
    """Loop transcription: right-closed pd.cut bins; a trapezoid panel
    counts only when both samples share a bin; empty bins are 0."""
    n_bins = len(edges) - 1
    codes = np.full(x.shape, -1, dtype=int)
    for k in range(n_bins):
        codes[(x > edges[k]) & (x <= edges[k + 1])] = k
    out = np.zeros(values.shape[:-1] + (n_bins,))
    for i in range(len(x) - 1):
        if codes[i] >= 0 and codes[i] == codes[i + 1]:
            out[..., codes[i]] += (
                (values[..., i] + values[..., i + 1]) / 2
                * (x[i + 1] - x[i]))
    return out


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(5)
    n_hr, n_bins = 4001, 37
    x = np.sort(rng.uniform(0.5, 10.0, n_hr))
    edges = np.logspace(np.log10(0.48), np.log10(10.2), n_bins + 1)
    values = rng.lognormal(0.0, 2.0, (6, n_hr))
    return x, edges, values


def test_bin_codes_right_closed(problem):
    x, edges, _ = problem
    codes = trebin.bin_codes(torch.tensor(x), torch.tensor(edges))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jrebin.bin_codes(jnp.asarray(x),
                                                   jnp.asarray(edges))))
    np.testing.assert_array_equal(codes.numpy(),
                                  trebin.bin_codes_np(x, edges))
    # exactly on an inner edge -> lower bin (right-closed)
    assert int(trebin.bin_codes(torch.tensor(edges[3]),
                                torch.tensor(edges))) == 2
    # below the first edge or above the last -> -1
    assert int(trebin.bin_codes(torch.tensor(edges[0]),
                                torch.tensor(edges))) == -1
    assert int(trebin.bin_codes(torch.tensor(edges[-1] + 1.0),
                                torch.tensor(edges))) == -1
    assert codes.min() >= 0 and codes.max() == len(edges) - 2


def test_resort_rebin_matches_oracle(problem):
    x, edges, values = problem
    want = trapz_in_bins_oracle(values, x, edges)
    got = trebin.resort_rebin(torch.tensor(values), torch.tensor(x),
                              edges).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    jax_ = np.asarray(jrebin.resort_rebin(jnp.asarray(values),
                                          jnp.asarray(x),
                                          jnp.asarray(edges)))
    np.testing.assert_allclose(got, jax_, rtol=1e-12)
    # batched over leading axes
    got3 = trebin.resort_rebin(torch.tensor(values.reshape(2, 3, -1)),
                               torch.tensor(x), edges).numpy()
    np.testing.assert_array_equal(got3.reshape(6, -1), got)


def test_empty_bins_are_zero():
    x = np.array([1.0, 1.1, 5.0, 5.1])
    edges = np.array([0.5, 2.0, 3.0, 6.0])
    got = trebin.resort_rebin(torch.tensor(x * 0 + 2.0), torch.tensor(x),
                              edges).numpy()
    assert got[1] == 0.0          # bin (2, 3] has no samples
    np.testing.assert_allclose(got[0], 2.0 * 0.1)
    np.testing.assert_allclose(got[2], 2.0 * 0.1, rtol=1e-12)


def test_reference_scaling(problem):
    x, edges, values = problem
    binned = trebin.resort_rebin(torch.tensor(values), torch.tensor(x),
                                 edges)
    scaled = trebin.reference_bin_scaling(binned, edges).numpy()
    want = np.asarray(jrebin.reference_bin_scaling(
        jnp.asarray(binned.numpy()), jnp.asarray(edges)))
    np.testing.assert_allclose(scaled, want, rtol=1e-14)
    width = edges[1:] - edges[:-1]
    np.testing.assert_allclose(scaled, binned.numpy() * width * 1e-3,
                               rtol=1e-12)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "count"])
def test_grouped_aggregate_ops(op):
    """Generic aggregation against a per-bin numpy loop and the JAX
    package (the reference's numpy_groupies surface,
    `interp.py:223-243`)."""
    rng = np.random.RandomState(5)
    x = np.sort(rng.uniform(0.0, 10.0, 300))
    edges = np.linspace(-1.0, 11.0, 14)   # includes empty end bins
    vals = rng.randn(2, 300)
    got = trebin.grouped_aggregate(torch.tensor(vals), torch.tensor(x),
                                   edges, op=op, fill=0.0).numpy()
    fns = {"sum": np.sum, "mean": np.mean, "max": np.max,
           "min": np.min, "count": len}
    want = np.zeros((2, 13))
    for k in range(13):
        m = (x > edges[k]) & (x <= edges[k + 1])
        if m.any():
            for b in range(2):
                want[b, k] = fns[op](vals[b, m]) if op != "count" \
                    else float(m.sum())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    jax_ = np.asarray(jrebin.grouped_aggregate(
        jnp.asarray(vals), jnp.asarray(x), jnp.asarray(edges), op=op,
        fill=0.0))
    np.testing.assert_allclose(got, jax_, rtol=1e-12, atol=1e-12)


def test_grouped_aggregate_trapz_alias_and_unknown_op():
    rng = np.random.RandomState(6)
    x = np.linspace(0.5, 10.0, 500)
    edges = np.geomspace(0.5, 10.0, 21)
    vals = torch.tensor(rng.rand(3, 500))
    a = trebin.grouped_aggregate(vals, torch.tensor(x), edges, op="trapz")
    b = trebin.resort_rebin(vals, torch.tensor(x), edges)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown aggregation op"):
        trebin.grouped_aggregate(vals, torch.tensor(x), edges, op="median")


def test_float32_coordinates_use_host_codes():
    """An interior sample within a float32 ulp of a bin edge is
    misassigned (or its panel dropped) when bin codes and panel widths
    come from downcast coordinates; the ETL decides both on the float64
    host grid (the rebin plan)."""
    edges = np.array([1.0, 1.0 + 5e-8, 2.0], np.float64)
    x = np.array([0.9, 1.0 + 1e-8, 1.0 + 4e-8, 1.5, 1.9], np.float64)
    vals = np.ones((1, 5), np.float32)
    want = trebin.resort_rebin(torch.tensor(vals, dtype=torch.float64),
                               torch.tensor(x), edges).numpy()
    assert want[0, 0] > 0      # the sub-ulp bin really has a panel
    got = trebin.resort_rebin(
        torch.tensor(vals), torch.tensor(x, dtype=torch.float32),
        torch.tensor(edges, dtype=torch.float32),
        codes=trebin.bin_codes_np(x, edges),
        dx=torch.tensor(np.diff(x), dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plan = RC.make_rebin_plan(x, edges)
    np.testing.assert_allclose(RC.rebin_plain(torch.tensor(vals),
                                              plan).numpy(), want, rtol=1e-6)
    # without host codes the float32 path cannot even see the bin
    f32 = trebin.resort_rebin(torch.tensor(vals),
                              torch.tensor(x, dtype=torch.float32),
                              torch.tensor(edges, dtype=torch.float32))
    assert float(f32[0, 0]) == 0.0


def test_twin_matches_pallas_kernel_interpret():
    """The kernel's twin against the JAX TPU kernel run in interpret
    mode, at ragged sizes (777 samples, 3 rows, edges past both ends)."""
    rng = np.random.RandomState(9)
    x = np.sort(rng.uniform(0.0, 1.0, 777))
    edges = np.linspace(-0.01, 1.01, 12)
    values = rng.uniform(0, 1, (3, 777))
    want = trapz_in_bins_oracle(values, x, edges)
    pallas = np.asarray(resort_rebin_pallas(
        jnp.asarray(values), jnp.asarray(x), jnp.asarray(edges),
        interpret=True))
    plan = RC.make_rebin_plan(x, edges)
    got = RC.rebin_plain(torch.tensor(values), plan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-7)


def test_rebin_plan_ranges_match_codes(problem):
    """Each bin's [start, stop) range holds exactly the samples the
    codes assign to it, also for empty and one-sample bins."""
    x, edges, values = problem
    # a one-sample bin and an empty bin inside the grid
    gap = x[201] - x[200]
    edges = np.sort(np.concatenate([edges, [x[100] - 1e-9, x[100],
                                            x[200] + gap / 3,
                                            x[200] + 2 * gap / 3]]))
    plan = RC.make_rebin_plan(x, edges)
    codes = plan.codes.numpy()
    for b in range(plan.n_bins):
        members = np.nonzero(codes == b)[0]
        lo, hi = int(plan.start[b]), int(plan.stop[b])
        np.testing.assert_array_equal(members, np.arange(lo, hi))
    counts = (plan.stop - plan.start).numpy()
    assert 0 in counts and 1 in counts
    got = RC.rebin_plain(torch.tensor(values), plan).numpy()
    np.testing.assert_allclose(got, trapz_in_bins_oracle(values, x, edges),
                               rtol=1e-12, atol=1e-300)
    with pytest.raises(ValueError, match="ascending"):
        RC.make_rebin_plan(x[::-1], edges)


def test_rebin_wrapper_on_cpu_runs_the_twin(problem):
    """On CPU tensors the wrapper runs the plain twin and launches (and
    counts) nothing; arguments it cannot take raise on any device."""
    x, edges, values = problem
    plan = RC.make_rebin_plan(x, edges)
    rows = torch.tensor(values, dtype=torch.float32)
    n0 = RC.rebin_kernel.launches
    assert torch.equal(RC.rebin_kernel(rows, plan), RC.rebin_plain(rows,
                                                                   plan))
    assert RC.rebin_kernel.launches == n0
    with pytest.raises(ValueError, match="expected"):
        RC.rebin_kernel(rows[:, 1:], plan)
    with pytest.raises(TypeError, match="float32 or float64"):
        RC.rebin_kernel(rows.to(torch.float16), plan)
    with pytest.raises(TypeError, match="plan dx"):
        RC.rebin_kernel(rows, plan._replace(dx=plan.dx.float()))


def test_native_engine_matches_jax_and_twin():
    if not native_available():
        pytest.skip("no C++ toolchain available")
    rng = np.random.RandomState(2)
    x = np.sort(rng.uniform(0.5, 10.0, 3001))
    edges = np.logspace(np.log10(0.49), 1.0, 41)
    vals = rng.lognormal(0, 1, (7, 3001)).astype(np.float32)
    got = grouped_trapezoid_native(vals, x, edges)
    np.testing.assert_array_equal(got, j_native(vals, x, edges))
    want = RC.rebin_plain(torch.tensor(vals, dtype=torch.float64),
                          RC.make_rebin_plan(x, edges)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7)
