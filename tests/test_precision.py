"""Single-precision (float32) parity study.

The reference supports -DSINGLE_PRECISION builds (Makefile:42-44) with jprb
as float32; --precision single runs float32.  This test quantifies the f32
error against the f64 solution — fluxes should agree to ~1e-4 relative and
the conservation residual should stay below ~1e-3 W/m2 per unit incoming
flux.
"""

import numpy as np

from spartacus_surface_tpu.models.solver import (
    SolverOptions, spartacus_lw, spartacus_sw)
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
from tests.test_solver_conservation import add_lw, make_inputs, residual_sw
import pytest

pytestmark = pytest.mark.slow


def _cast(inp, dtype):
    import dataclasses
    import jax

    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x, dtype), inp
    )


def test_sw_f32_matches_f64():
    rng = np.random.default_rng(2024)
    inp64 = make_inputs(rng, C=6, L=4, S=1, urban=True)
    inp32 = _cast(inp64, np.float32)
    opt = SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)
    d64, f64_, bc64 = spartacus_sw(inp64, opt, lg)
    d32, f32_, bc32 = spartacus_sw(inp32, opt, lg)
    assert np.asarray(d32["ground_dn"]).dtype == np.float32
    for key in ("ground_dn", "ground_net", "top_net"):
        a = np.asarray(d64[key])
        b = np.asarray(d32[key])
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=key)
    np.testing.assert_allclose(
        np.asarray(bc64["top_albedo_dir"]),
        np.asarray(bc32["top_albedo_dir"]), rtol=2e-3, atol=2e-4,
    )
    # f32 conservation residual stays small (per unit incoming flux)
    assert np.abs(residual_sw(d32)).max() < 1e-3


def test_lw_f32_conservation():
    rng = np.random.default_rng(2025)
    inp = add_lw(make_inputs(rng, C=4, L=3, S=1, urban=True), rng)
    inp32 = _cast(inp, np.float32)
    opt = SolverOptions(nreg=2, nstream=2, do_urban=True)
    lg = LegendreGauss(2)
    i64, n64, _ = spartacus_lw(inp, opt, lg)
    i32, n32, _ = spartacus_lw(inp32, opt, lg)
    # Absolute fluxes are O(300 W/m2); require ~0.1% agreement and
    # sub-W/m2 conservation residual in f32
    np.testing.assert_allclose(
        np.asarray(i64["ground_net"]), np.asarray(i32["ground_net"]),
        rtol=2e-3, atol=0.3,
    )
    assert np.abs(residual_sw(i32)).max() < 1.0
    assert np.abs(residual_sw(n32)).max() < 5e-3
