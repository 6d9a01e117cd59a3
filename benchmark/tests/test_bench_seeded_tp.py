"""The seeded T- and P-dependent opacity tables (``"kind": "seeded_tp"``):
the fixture's properties and seeding, the dispatch that leaves every
existing configuration's inputs byte for byte as they were, the port
against the plain reference on four species, and a fault in the layer
tables that only T-dependent tables can show."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from benchmark.harness import cell, pieces, program
from benchmark.reference import answers, case, inputs
from benchmark.tools import seeded_tp

MAN = pieces.manifest()
#: the float64 forward cell's limits: the fixture's cell is held to them
LIMITS = pieces.limits("hj_loop_f64")
SMALL = {"n_wl_bins": 64, "n_layers": 12}
COLUMNS, ITERS = 4, 3
SMALL_TRAFFIC = {"columns": COLUMNS, "iterations": ITERS, "pool": 1}
SEED = 2 ** 31 + 91

#: SHA-256 of what each cell reads at seeds 0 and 1 (its raw tables, its
#: profile pool and, for a population, its draws), recorded before the
#: seeded tables were added
DIGESTS = {
    "tables": "1bcfd7874a1c0403b94a3e7244f792ad64392a01708e79efbf885559675e1a56",
    ("hj_loop_f64", 0, "pool"): "5be57e280a362f953ab9c1516a7e6bf05ca78f2320604df02ca3937cc705e884",
    ("hj_loop_f64", 1, "pool"): "6a760c79c8839218c643a3285605fa864f88ca702e31700e64023859ba158c95",
    ("pop_auto_f64", 0, "pool"): "5be57e280a362f953ab9c1516a7e6bf05ca78f2320604df02ca3937cc705e884",
    ("pop_auto_f64", 1, "pool"): "6a760c79c8839218c643a3285605fa864f88ca702e31700e64023859ba158c95",
    ("pop_auto_f64", 0, "draws"): "b0052b60b9b57707765a92ce2b3fad563721ec40022d741b381096ddc3ea296f",
    ("pop_auto_f64", 1, "draws"): "4ba9e1bc34bd1b7ff3e7aa2dfd148eaa407937f4d203fe7ffd259ee90c44468f",
    ("hj_grad", 0, "pool"): "0c4d6dfc6b49296ec5f22874f44483666c249d9e50d0052fd039ccaa6e419246",
    ("hj_grad", 1, "pool"): "22594deecefcef539e3932a3382bc0145f44bde7e71922132904289e896cbcb6",
}


def sha256(arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        d.update(str((a.dtype.str, a.shape)).encode())
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()


def tables_of(cfg):
    return case.opacity_tables(cfg, inputs.grid_arrays(cfg["grid"]))


@pytest.fixture(scope="module")
def golden():
    """The four species on the golden grid (500 bins, 30 layers)."""
    cfg = seeded_tp.config()
    return cfg, tables_of(cfg)


def log_mix(cfg, tables):
    """log10 of the species' sum at the configuration's mixing ratios,
    (nT, nP, W): the molecular opacity the solve sees."""
    s, _ = case.build(cfg, tables, torch.float64, "cpu")
    return np.log10(np.einsum("s,stpw->tpw", s.mmr.numpy(),
                              s.table.numpy()))


def test_every_value_is_finite_and_positive_on_shared_axes(golden):
    cfg, tables = golden
    ga = inputs.grid_arrays(cfg["grid"])
    assert list(tables) == seeded_tp.OPACITY["species"]
    T_axis, P_axis = next(iter(tables.values()))[1:]
    for values, temps, press in tables.values():
        assert values.shape == (30, 21, 500) and values.dtype == np.float64
        assert np.isfinite(values).all() and (values > 0).all()
        assert temps is T_axis and press is P_axis
    assert P_axis[0] <= ga.pressures_bar.min()
    assert P_axis[-1] >= ga.pressures_bar.max()
    assert T_axis[0] < 0.95 * ga.init_temps.min()
    assert T_axis[-1] > 1.05 * ga.init_temps.max()


def test_kappa_depends_on_temperature(golden):
    """At fixed (wavelength, pressure), each species and their mix span
    at least 1 dex over the T axis in at least half the bins."""
    cfg, tables = golden
    logs = [np.log10(v) for v, _, _ in tables.values()]
    for lv in logs + [log_mix(cfg, tables)]:
        assert ((lv.max(0) - lv.min(0)) >= 1.0).mean() >= 0.5


def test_kappa_depends_on_pressure(golden):
    """At fixed (wavelength, temperature), the mix moves at least 0.3 dex
    between the P axis's ends in at least a quarter of the bins (the
    windows filled at depth)."""
    lv = log_mix(*golden)
    assert (np.abs(lv[:, -1] - lv[:, 0]) >= 0.3).mean() >= 0.25


def test_unit_optical_depth_lies_inside_the_atmosphere(golden):
    """On the golden grid at the initial profile, the level where the
    optical depth from the top reaches 1 lies between layer 1 and layer
    L - 2 in at least 80% of the bins: the bottom interval is not needed
    to reach it, and the top interval alone stays under it."""
    cfg, tables = golden
    ga = inputs.grid_arrays(cfg["grid"])
    s, ph = case.build(cfg, tables, torch.float64, "cpu")
    from benchmark.reference import rt
    k = rt.kappa(s, torch.as_tensor(ga.init_temps)[None])[0]   # (L, W)
    p = s.pressures
    dtau = (p[:-1] - p[1:])[:, None] / ph.g * k[:-1]
    tau = dtau.flip(0).cumsum(0).flip(0)      # from the top to layer l
    L = p.shape[0]
    deep = torch.arange(L - 1)[:, None].expand_as(tau)
    level = torch.where(tau >= 1.0, deep, -1).amax(0)
    assert ((level >= 1) & (level <= L - 3)).double().mean() >= 0.8


def test_same_seed_same_bytes_other_seed_other_bytes(golden):
    cfg, tables = golden
    again = tables_of(cfg)
    other = copy.deepcopy(cfg)
    other["opacity"]["seed"] += 1
    moved = tables_of(other)
    for name, (values, _, _) in tables.items():
        assert values.tobytes() == again[name][0].tobytes()
        assert not np.array_equal(values, moved[name][0])


def test_a_species_keeps_its_bytes_when_another_is_added(golden):
    cfg, tables = golden
    fewer = copy.deepcopy(cfg)
    fewer["opacity"]["species"] = fewer["opacity"]["species"][:2]
    for name, (values, _, _) in tables_of(fewer).items():
        assert values.tobytes() == tables[name][0].tobytes()


@pytest.mark.parametrize("change", [{"kind": "no_such_kind"},
                                    {"species": ["1H2-16O", "no_such"]}])
def test_unknown_kind_or_species_is_named(change):
    cfg = seeded_tp.config(**SMALL)
    cfg["opacity"].update(change)
    with pytest.raises(ValueError, match="no_such"):
        tables_of(cfg)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell_name", [w["name"] for w in MAN["workloads"]])
def test_existing_cells_read_the_same_bytes(cell_name, seed):
    """The tables, profile pools and population draws of every cell as
    they were before the seeded kind was added."""
    ctx = cell.Context(cell_name, seed, "cpu", MAN)
    state = pieces.entry(ctx.traffic["entry"]).prepare(ctx)
    assert sha256([x for n in ctx.tables for x in (
        np.frombuffer(n.encode(), np.uint8), *ctx.tables[n])]) \
        == DIGESTS["tables"]
    assert sha256(list(state.T0) + list(state.T0_ref)) \
        == DIGESTS[cell_name, seed, "pool"]
    if hasattr(state, "draws"):
        assert sha256([x for d in state.draws for x in d]) \
            == DIGESTS[cell_name, seed, "draws"]


def small_solve(engine, seed=SEED):
    """The port's fixed-horizon solve of the four species at the small
    size, and the reference's answers for the same profiles."""
    from frei_tpu_torch import solve_rc_batched
    cfg = seeded_tp.config(**SMALL)
    ctx = seeded_tp.context(cfg, seed, "cpu", **SMALL_TRAFFIC)
    grid = program.make_grid(ctx)
    (T0,), (T0_ref,) = program.profile_pool(ctx)
    res = solve_rc_batched(T0, grid._consts, grid.planet.physics_params(),
                           grid._kappa_fn,
                           program.fixed_horizon(ctx, engine=engine))
    ref = answers.forward(cfg, ctx.tables, T0_ref, None, ITERS,
                          torch.float64, "cpu", 3)
    return answers.forward_gaps({"flux": res.flux,
                                 "final_temps": res.final_temps}, ref)


def correct(gaps) -> bool:
    return all(c["value"] <= c["limit"]
               for c in cell.judged(gaps, LIMITS).values())


@pytest.mark.parametrize("engine", ["eager", "loop"])
def test_port_agrees_on_four_species(engine):
    gaps = small_solve(engine)
    assert correct(gaps), gaps


def test_hoisted_pressure_axis_is_far_inside_the_limits():
    """The reference's bilinear lookup against the same lookup with the
    pressure axis hoisted onto the layers first, the order of the
    program's layer tables: equal in real arithmetic; in float64 at
    least 100 times under each limit."""
    cfg = seeded_tp.config(**SMALL)
    ctx = seeded_tp.context(cfg, SEED, "cpu", **SMALL_TRAFFIC)
    (_,), (T0,) = program.profile_pool(ctx)
    args = (cfg, ctx.tables, T0, None, ITERS, torch.float64, "cpu", 4)
    gaps = answers.forward_gaps(seeded_tp.hoisted_reference(*args),
                                answers.forward(*args))
    for name, lim in LIMITS.items():
        assert gaps[name] <= lim["limit"] / 100, gaps


def reversed_temperature_rows(patch):
    """Each layer table's temperature rows in reverse order: a lookup at
    T reads the row of another temperature."""
    import frei_tpu_torch.opacity.hotpath as hotpath
    inner = hotpath.make_layer_tables

    def make(stack, pressures):
        lt = inner(stack, pressures)
        L, _, W = lt.tab.shape
        tab = lt.tab.reshape(L, lt.n_species, -1, W).flip(2)
        return lt._replace(tab=tab.reshape(L, -1, W).contiguous())
    patch(hotpath, "make_layer_tables", make)


@pytest.mark.parametrize("engine", ["eager", "loop"])
def test_reversed_temperature_rows_are_caught(engine, monkeypatch):
    reversed_temperature_rows(monkeypatch.setattr)
    gaps = small_solve(engine)
    assert not correct(gaps), gaps


def test_example_tables_cannot_show_reversed_temperature_rows(monkeypatch):
    """On ``hot_jupiter_r500_f64``'s example tables every temperature row
    is the same, so the fault leaves kappa unchanged to the bit: no
    existing cell's ``correct`` can see it."""
    ctx = cell.Context(seeded_tp.CELL, SEED, "cpu", overrides=SMALL_TRAFFIC)
    (T0,), _ = program.profile_pool(ctx)
    p = torch.as_tensor(ctx.grid.pressures)
    sound = program.make_grid(ctx)._kappa_fn(T0, p)
    reversed_temperature_rows(monkeypatch.setattr)
    assert torch.equal(program.make_grid(ctx)._kappa_fn(T0, p), sound)
