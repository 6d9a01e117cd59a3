"""End-to-end retrieval with frei_tpu_torch, mirroring
``tests/test_retrieval.py`` with ``torch.optim.LBFGS`` in place of optax:
the differentiable solve must bring an optimizer to known parameters,
not merely give finite gradients.

``Grid.spectrum_fn`` recovers gravity, an initial-temperature scale and
an irradiation scale (the ``T_star`` / ``a_rstar`` knob) from a
synthetic spectrum, from a start 60 %, 8 % and -20 % off, each to 1e-3
relative.  The mixing length alpha is not identifiable from this
observable (convection shapes the deep adiabat, not the emergent
spectrum): its Jacobian column is pinned at under 1e-3 of gravity's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402

torch.set_num_threads(2)
W, L, NT = 32, 12, 4
F64 = torch.float64


@pytest.fixture(scope="module")
def setup():
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
                T_ref=2400.0, dtype=F64, device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=F64))
    fn = grid.spectrum_fn(n_timesteps=NT, n_zero_crossings=10 ** 6,
                          convergence_dT=0.0)
    p0 = grid.planet.physics_params()
    T_base = torch.tensor(np.asarray(grid.init_temperatures))[None, :]
    F0 = grid._consts.F_toa[None, :]
    return fn, p0, T_base, F0


def test_lbfgs_recovers_g_T0scale_irradiation(setup):
    """Recover (g, T0 scale, F_toa scale) in log space from a synthetic
    observation, starting (+60 %, +8 %, -20 %) off the truth; every
    parameter within 1e-3 relative."""
    fn, p0, T_base, F0 = setup

    def model(theta):
        lg, ls, lf = theta
        par = PhysicsParams(g=torch.exp(lg), m_bar=p0.m_bar,
                            alpha=p0.alpha, n_dof=p0.n_dof)
        return fn(T_base * torch.exp(ls), par, F_toa=F0 * torch.exp(lf))[0]

    truth = torch.log(torch.tensor([p0.g, 1.0, 1.0], dtype=F64))
    with torch.no_grad():
        observed = model(truth)

    def loss(theta):
        return ((model(theta) - observed) ** 2).mean() / (observed ** 2).mean()

    theta = torch.log(torch.tensor([p0.g * 1.6, 1.08, 0.8],
                                   dtype=F64)).requires_grad_(True)
    # LBFGS keeps a curvature pair only where y.s > 1e-10, an absolute
    # threshold, and the relative loss's curvature along the irradiation
    # scale is ~1e-7: the objective is the loss x 1e12 (the same
    # optimum); optax's lbfgs has no such threshold
    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=100,
                            tolerance_grad=1e-9, tolerance_change=1e-12,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        v = 1e12 * loss(theta)
        v.backward()
        return v

    opt.step(closure)
    with torch.no_grad():
        v = float(loss(theta))
    got = torch.exp(theta.detach()).numpy()
    want = torch.exp(truth).numpy()
    rel = np.abs(got - want) / want
    assert v < 1e-12, f"loss did not converge: {v}"
    assert np.all(rel < 1e-3), f"recovered {got} vs true {want} ({rel})"


def test_mixing_length_alpha_is_not_identifiable(setup):
    """d(spectrum)/d(log alpha) is under 1e-3 of d/d(log g), while
    gravity and the T0 scale are identifiable."""
    fn, p0, T_base, _ = setup

    def model(theta):
        lg, la, ls = theta
        par = PhysicsParams(g=torch.exp(lg), m_bar=p0.m_bar,
                            alpha=torch.exp(la), n_dof=p0.n_dof)
        return fn(T_base * torch.exp(ls), par)[0]

    truth = torch.log(torch.tensor([p0.g, p0.alpha, 1.0], dtype=F64))
    with torch.no_grad():
        obs = model(truth)
    scale = (obs ** 2).mean() ** 0.5
    J = torch.autograd.functional.jacobian(
        lambda th: (model(th) - obs) / scale, truth)
    norms = torch.linalg.vector_norm(J, dim=0)      # (g, alpha, s)
    assert torch.isfinite(J).all()
    assert norms[0] > 1.0 and norms[2] > 1.0
    assert norms[1] < 1e-3 * norms[0], (
        f"alpha sensitivity {float(norms[1]):.3g} vs g "
        f"{float(norms[0]):.3g}: alpha became identifiable")
