"""Energy-conservation tests for the unified SPARTACUS solver.

The invariant is the reference's own conservation check
(radsurf/radsurf_canopy_flux.F90:465-542): for each normalized flux
component, ground_net + clear_air_abs + wall_net + roof_net + veg_abs +
veg_air_abs - top_net == 0 per column.  The reference documentation's worked
example shows residuals ~1e-13 (SW) in double precision
(doc/spartacus_surface_documentation.tex:955-979).
"""

import numpy as np
import pytest

from spartacus_surface_tpu.models.solver import (
    CanopyInputs,
    SolverOptions,
    spartacus_lw,
    spartacus_sw,
)
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu.utils.constants import StefanBoltzmann


def make_inputs(rng, C=4, L=3, S=2, urban=True, pad_layers=0, seed_pad=None):
    """Random physically-plausible canopy inputs (padding above canopy)."""
    Lp = L + pad_layers
    def pad_l(x, fill=0.0):
        if pad_layers == 0:
            return x
        return np.concatenate(
            [x, np.full((C, pad_layers) + x.shape[2:], fill, x.dtype)], axis=1
        )

    dz = pad_l(rng.uniform(2.0, 8.0, (C, L)))
    veg_fraction = pad_l(rng.uniform(0.05, 0.4, (C, L)))
    building_fraction = pad_l(
        rng.uniform(0.05, 0.35, (C, L)) if urban else np.zeros((C, L))
    )
    # Make building fraction non-increasing with height (usual city)
    building_fraction = np.sort(building_fraction, axis=1)[:, ::-1]
    if pad_layers:
        building_fraction[:, L:] = 0.0

    inp = CanopyInputs(
        dz=dz,
        cos_sza=rng.uniform(0.2, 0.95, C),
        veg_fraction=veg_fraction,
        veg_scale=pad_l(rng.uniform(50.0, 200.0, (C, L)), fill=1.0),
        veg_ext=pad_l(rng.uniform(0.1, 0.6, (C, L))),
        veg_fsd=pad_l(rng.uniform(0.3, 1.0, (C, L))),
        veg_contact_fraction=pad_l(rng.uniform(0.0, 0.6, (C, L))),
        building_fraction=building_fraction,
        building_scale=pad_l(rng.uniform(20.0, 100.0, (C, L)), fill=1.0),
        air_ext=pad_l(np.full((C, L, S), 1.0e-5)),
        air_ssa=pad_l(np.full((C, L, S), 0.999)),
        veg_ssa=pad_l(rng.uniform(0.3, 0.7, (C, L, S))),
        ground_albedo=rng.uniform(0.05, 0.4, (C, S)),
        ground_albedo_dir=rng.uniform(0.05, 0.4, (C, S)),
        roof_albedo=pad_l(rng.uniform(0.1, 0.4, (C, L, S))),
        roof_albedo_dir=pad_l(rng.uniform(0.1, 0.4, (C, L, S))),
        wall_albedo=pad_l(rng.uniform(0.1, 0.4, (C, L, S))),
        wall_specular_frac=pad_l(rng.uniform(0.0, 0.5, (C, L, S))),
    )
    return inp


def add_lw(inp, rng):
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    tg = rng.uniform(280.0, 300.0, (C,))
    eg = rng.uniform(0.9, 1.0, (C, S))
    tw = rng.uniform(280.0, 300.0, (C, L))
    tr = rng.uniform(280.0, 300.0, (C, L))
    er = rng.uniform(0.85, 1.0, (C, L, S))
    ew = rng.uniform(0.85, 1.0, (C, L, S))
    sb = StefanBoltzmann
    inp.air_ssa = np.zeros_like(inp.air_ssa)
    inp.ground_emissivity = eg
    inp.ground_emission = sb * eg * tg[:, None] ** 4
    inp.roof_emissivity = er
    inp.roof_emission = sb * er * tr[:, :, None] ** 4
    inp.wall_emissivity = ew
    inp.wall_emission = sb * ew * tw[:, :, None] ** 4
    inp.clear_air_planck = sb * rng.uniform(275.0, 295.0, (C, L, 1)) ** 4 * np.ones((1, 1, S))
    inp.veg_planck = sb * rng.uniform(275.0, 295.0, (C, L, 1)) ** 4 * np.ones((1, 1, S))
    inp.veg_air_planck = sb * rng.uniform(275.0, 295.0, (C, L, 1)) ** 4 * np.ones((1, 1, S))
    return inp


def residual_sw(out):
    r = np.asarray(out["ground_net"]).sum(-1)
    for key in ("clear_air_abs", "veg_abs", "veg_air_abs", "wall_net",
                "roof_net"):
        if key in out:
            r = r + np.asarray(out[key]).sum((-1, -2))
    return r - np.asarray(out["top_net"]).sum(-1)


@pytest.mark.parametrize("urban,nreg,ns", [
    (True, 1, 4), (True, 2, 4), (False, 2, 4), (False, 3, 2), (True, 3, 1),
])
def test_sw_conservation(urban, nreg, ns):
    rng = np.random.default_rng(123)
    inp = make_inputs(rng, urban=urban)
    opt = SolverOptions(nreg=nreg, nstream=ns, do_urban=urban)
    lg = LegendreGauss(ns)
    norm_dir, norm_diff, bc = spartacus_sw(inp, opt, lg)
    res_dir = residual_sw(norm_dir)
    res_diff = residual_sw(norm_diff)
    np.testing.assert_allclose(res_dir, 0.0, atol=2e-10)
    np.testing.assert_allclose(res_diff, 0.0, atol=2e-10)
    # Albedos physical
    for key in ("top_albedo_diff", "top_albedo_dir"):
        a = np.asarray(bc[key])
        assert np.all(a > 0.0) and np.all(a < 1.0)


@pytest.mark.parametrize("urban,nreg,ns", [
    (True, 1, 4), (True, 2, 2), (False, 2, 4),
])
def test_lw_conservation(urban, nreg, ns):
    rng = np.random.default_rng(321)
    inp = add_lw(make_inputs(rng, urban=urban), rng)
    opt = SolverOptions(nreg=nreg, nstream=ns, do_urban=urban)
    lg = LegendreGauss(ns)
    internal, norm, bc = spartacus_lw(inp, opt, lg)
    np.testing.assert_allclose(residual_sw(internal), 0.0, atol=1e-9)
    np.testing.assert_allclose(residual_sw(norm), 0.0, atol=1e-10)
    e = np.asarray(bc["top_emissivity"])
    assert np.all(e > 0.0) and np.all(e <= 1.0)
    assert np.all(np.asarray(bc["top_emission"]) > 0.0)


def test_padding_is_noop_sw():
    """dz=0 padding layers must not change any output."""
    rng = np.random.default_rng(99)
    inp0 = make_inputs(np.random.default_rng(7), urban=True)
    inp1 = make_inputs(np.random.default_rng(7), urban=True, pad_layers=3)
    opt = SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)
    d0, f0, b0 = spartacus_sw(inp0, opt, lg)
    d1, f1, b1 = spartacus_sw(inp1, opt, lg)
    L = inp0.dz.shape[1]
    for key in d0:
        a, b = np.asarray(d0[key]), np.asarray(d1[key])
        if a.ndim >= 2 and a.shape[1] == L:
            b = b[:, :L]
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=key)
    for key in b0:
        np.testing.assert_allclose(
            np.asarray(b0[key]), np.asarray(b1[key]), atol=1e-12, err_msg=key
        )


def test_forest_equals_urban_with_zero_buildings():
    """Running a forest through the urban machinery must equal running it
    with do_urban=True and building_fraction=0 (the reference consistency
    property, test/simple/README:8-11)."""
    rng = np.random.default_rng(5)
    inp = make_inputs(rng, urban=False)
    lg = LegendreGauss(4)
    f_dir, f_diff, f_bc = spartacus_sw(
        inp, SolverOptions(nreg=2, nstream=4, do_urban=False), lg
    )
    u_dir, u_diff, u_bc = spartacus_sw(
        inp, SolverOptions(nreg=2, nstream=4, do_urban=True), lg
    )
    for key in ("ground_dn", "ground_net", "top_net", "clear_air_abs",
                "veg_abs"):
        np.testing.assert_allclose(
            np.asarray(f_dir[key]), np.asarray(u_dir[key]), atol=1e-12,
            err_msg=key,
        )
    np.testing.assert_allclose(
        np.asarray(f_bc["top_albedo_dir"]), np.asarray(u_bc["top_albedo_dir"]),
        atol=1e-12,
    )


def test_column_chunked_solve_matches_unchunked():
    """opt.column_chunk (lax.map over padded column chunks) is exact:
    chunk boundary and no-op padding columns must not change any output."""
    import jax

    from spartacus_surface_tpu.models.solver import SolverOptions, spartacus_sw

    rng = np.random.default_rng(41)
    inp = make_inputs(rng, C=10, L=2, S=2, urban=True)
    inp = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x, np.float32), inp
    )
    lg = LegendreGauss(2)
    kw = dict(nreg=2, nstream=2, do_urban=True, n_double=6)
    ref = spartacus_sw(inp, SolverOptions(**kw), lg)
    got = spartacus_sw(inp, SolverOptions(**kw, column_chunk=4), lg)
    for rd, pd in zip(ref, got):
        for k in rd:
            np.testing.assert_allclose(
                np.asarray(pd[k]), np.asarray(rd[k]),
                rtol=2e-5, atol=1e-6, err_msg=k,
            )


def test_auto_column_chunk_resolution(monkeypatch):
    """column_chunk = -1 (AUTO) resolves from the device memory limit
    (utils/memory.py): no chunking where the device reports none (the
    CPU), the fewest even chunks that fit otherwise; explicit values pass
    through untouched."""
    from spartacus_surface_tpu.models.solver import (
        SolverOptions, _resolve_column_chunk)
    from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu.utils import memory

    lg = LegendreGauss(4)
    base = dict(nreg=2, nstream=4, do_urban=True)

    # Explicit values pass through
    assert _resolve_column_chunk(
        SolverOptions(**base), lg, 10**6, 8, 1, 4) == 0
    assert _resolve_column_chunk(
        SolverOptions(**base, column_chunk=4096), lg, 10**6, 8, 1, 4) == 4096
    # AUTO on the CPU backend (no memory limit): no chunking
    opt = SolverOptions(**base, column_chunk=-1)
    assert _resolve_column_chunk(opt, lg, 10**6, 8, 1, 4) == 0
    # AUTO under a device limit: chunks hold the share, split evenly
    per_col = memory.solve_bytes_per_column(2, 4, 8, 1, 4)
    monkeypatch.setattr(memory, "device_bytes_limit",
                        lambda: int(1000 * per_col / memory.SOLVE_SHARE))
    assert _resolve_column_chunk(opt, lg, 1000, 8, 1, 4) == 0  # fits
    assert _resolve_column_chunk(opt, lg, 4000, 8, 1, 4) == 1000
    ck = _resolve_column_chunk(opt, lg, 2999, 8, 1, 4)  # 3 chunks
    assert ck == 1000 and -(-2999 // ck) == 3
    # Multiband and double precision shrink the chunk in proportion
    assert _resolve_column_chunk(opt, lg, 1000, 8, 2, 4) == 500
    assert _resolve_column_chunk(opt, lg, 1000, 8, 1, 8) == 500


@pytest.mark.parametrize("gap", [1e-9, 1e-7, 1e-5])
def test_near_empty_roof_leaks_as_the_reference(tmp_path, gap):
    """An exposed roof narrower than min_building_fraction (1e-6) is
    excised, as the reference does, and the budget then leaks O(roof
    fraction) of the top flux; the NumPy reference tests/pyref leaks the
    same.  A wider roof closes the budget to rounding."""
    from spartacus_surface_tpu.driver import synthetic_input as si
    from spartacus_surface_tpu.driver.read_input import read_input
    from spartacus_surface_tpu.models import flux_utils
    from spartacus_surface_tpu.models.dispatch import run_radsurf
    from spartacus_surface_tpu.models.simple_spectrum import (
        calc_simple_spectrum_lw)
    from spartacus_surface_tpu.utils.config import Config, DriverConfig
    from tests.pyref.harness import pyref_radsurf

    nam, inp = si.write_deployment("coupled", str(tmp_path), ncol=6, seed=0)
    config = Config.from_namelist(nam).consolidate()
    arrays = read_input(inp, config, DriverConfig.from_namelist(nam))["arrays"]
    calc_simple_spectrum_lw(config, arrays)
    urban = np.isin(arrays["i_representation"], (2, 3))
    arrays = {k: v[urban] for k, v in arrays.items()}
    bf = arrays["building_fraction"]
    bf[:, 2] = bf[:, 1] - gap

    def residuals(out, key):
        comp = {k: np.asarray(v) for k, v in flux_utils.budget_components(
            out[key], arrays["i_representation"]).items()}
        return (comp["ground"] + comp["air"] + comp["wall"] + comp["roof"]
                + comp["veg"] + comp["veg_air"] - comp["top"])

    got = run_radsurf(config, arrays)
    want = pyref_radsurf(config, arrays)
    for key in ("sw_norm_dir", "sw_norm_diff", "lw_norm"):
        res, ref = residuals(got, key), residuals(want, key)
        np.testing.assert_allclose(res, ref, rtol=1e-4, atol=1e-14,
                                   err_msg=key)
        if gap < config.min_building_fraction:
            assert (np.abs(res) > 1e-3 * gap).all(), key
            assert (np.abs(res) < 1e3 * gap).all(), key
        else:
            assert np.abs(res).max() < 1e-14, key
