"""Parity of the O(log L)-depth associative-scan adding path.

SolverOptions.associative_sweeps replaces the sequential lax.scan adding and
flux recurrences with Redheffer-star prefix / affine suffix compositions
(ops/assoc_adding.py).  The two routes are algebraically identical maps
evaluated in a different association order, so on the f64 test backend they
must agree to near machine precision on EVERY output field, for forest and
urban, SW (both normalizations) and LW (both components), including deep
(64-layer) canopies where the parallel route actually earns its keep.
"""

import dataclasses

import numpy as np
import pytest

from spartacus_surface_tpu.models.solver import (
    SolverOptions,
    spartacus_lw,
    spartacus_sw,
)
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
from tests.test_solver_conservation import add_lw, make_inputs


def _opts(urban, nreg=2, ns=2, assoc=False):
    return SolverOptions(
        nreg=nreg, nstream=ns, do_urban=urban, n_double=8,
        associative_sweeps=assoc,
    )


def _assert_tree_close(ref, got, rtol, atol, where):
    assert set(ref.keys()) == set(got.keys()), where
    for k in ref:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), rtol=rtol, atol=atol,
            err_msg=f"{where}:{k}",
        )


@pytest.mark.parametrize("urban", [False, True])
@pytest.mark.parametrize("L", [1, 3, 11])
def test_sw_parity(urban, L):
    rng = np.random.default_rng(100 + L)
    inp = make_inputs(rng, C=3, L=L, S=2, urban=urban)
    lg = LegendreGauss(2)
    ref = spartacus_sw(inp, _opts(urban), lg, with_profiles=True)
    got = spartacus_sw(inp, _opts(urban, assoc=True), lg, with_profiles=True)
    _assert_tree_close(ref[0], got[0], 1e-9, 1e-11, "norm_dir")
    _assert_tree_close(ref[1], got[1], 1e-9, 1e-11, "norm_diff")
    _assert_tree_close(ref[2], got[2], 1e-9, 1e-12, "bc")


def test_sw_parity_nreg3():
    rng = np.random.default_rng(7)
    inp = make_inputs(rng, C=2, L=4, S=1, urban=True, pad_layers=2)
    lg = LegendreGauss(4)
    ref = spartacus_sw(inp, _opts(True, nreg=3, ns=4), lg)
    got = spartacus_sw(inp, _opts(True, nreg=3, ns=4, assoc=True), lg)
    _assert_tree_close(ref[0], got[0], 1e-9, 1e-11, "norm_dir")
    _assert_tree_close(ref[1], got[1], 1e-9, 1e-11, "norm_diff")
    _assert_tree_close(ref[2], got[2], 1e-9, 1e-12, "bc")


@pytest.mark.parametrize("urban", [False, True])
def test_lw_parity(urban):
    rng = np.random.default_rng(42)
    inp = make_inputs(rng, C=3, L=5, S=2, urban=urban)
    inp = add_lw(inp, rng)
    lg = LegendreGauss(2)
    ref = spartacus_lw(inp, _opts(urban), lg, with_profiles=True)
    got = spartacus_lw(inp, _opts(urban, assoc=True), lg, with_profiles=True)
    _assert_tree_close(ref[0], got[0], 1e-9, 1e-9, "internal")
    _assert_tree_close(ref[1], got[1], 1e-9, 1e-11, "incoming")
    _assert_tree_close(ref[2], got[2], 1e-9, 1e-11, "bc")


@pytest.mark.slow
def test_deep_canopy_parity():
    """64 layers — the regime the log-depth route exists for."""
    rng = np.random.default_rng(11)
    inp = make_inputs(rng, C=2, L=64, S=1, urban=True)
    # Thin layers so the 64-layer canopy stays optically sane
    inp = dataclasses.replace(inp, dz=np.asarray(inp.dz) * 0.12)
    lg = LegendreGauss(2)
    ref = spartacus_sw(inp, _opts(True), lg)
    got = spartacus_sw(inp, _opts(True, assoc=True), lg)
    _assert_tree_close(ref[0], got[0], 1e-8, 1e-10, "norm_dir")
    _assert_tree_close(ref[1], got[1], 1e-8, 1e-10, "norm_diff")
    lwi = add_lw(make_inputs(rng, C=2, L=64, S=1, urban=True), rng)
    refl = spartacus_lw(lwi, _opts(True), lg)
    gotl = spartacus_lw(lwi, _opts(True, assoc=True), lg)
    _assert_tree_close(refl[0], gotl[0], 1e-8, 1e-8, "internal")
    _assert_tree_close(refl[1], gotl[1], 1e-8, 1e-10, "incoming")


def test_star_combine_matches_two_step():
    """Unit check: one star combine == two sequential adding steps."""
    from spartacus_surface_tpu.ops.assoc_adding import (
        ground_star_element,
        star_combine,
        star_prefix,
    )
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n, p = 4, 2
    def rand(*s):
        return jnp.asarray(rng.uniform(0.05, 0.3, s))
    elems = {
        "Rd": rand(2, n, n), "Td": rand(2, n, n), "Ru": rand(2, n, n),
        "Tu": rand(2, n, n), "E": rand(2, p, p), "Su": rand(2, n, p),
        "Sd": rand(2, n, p),
    }
    ground = ground_star_element(rand(n, n), rand(n, p), p)
    prefix = star_prefix(elems, ground)
    one = {k: elems[k][0] for k in elems}
    two = {k: elems[k][1] for k in elems}
    seq = star_combine(star_combine(ground, one), two)
    for k in seq:
        np.testing.assert_allclose(
            np.asarray(prefix[k][2]), np.asarray(seq[k]), rtol=1e-12,
            atol=1e-14, err_msg=k,
        )
