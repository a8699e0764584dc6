"""End-to-end differentiability.

The whole solver is pure jittable JAX, so gradients of any flux output with
respect to any canopy property come for free — a capability the Fortran
reference does not have at all (useful for variational retrievals, tangent
linear models and ML coupling).  Checked against finite differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spartacus_surface_tpu.models.solver import (
    SolverOptions, spartacus_sw)
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
from tests.test_solver_conservation import make_inputs
import pytest

pytestmark = pytest.mark.slow


def test_grad_albedo_wrt_veg_ext():
    rng = np.random.default_rng(123)
    inp = make_inputs(rng, C=2, L=2, S=1, urban=False)
    opt = SolverOptions(nreg=2, nstream=2, do_urban=False, n_double=6)
    lg = LegendreGauss(2)

    def albedo(veg_ext):
        probe = dataclasses.replace(inp, veg_ext=veg_ext)
        _, _, bc = spartacus_sw(probe, opt, lg)
        return jnp.sum(bc["top_albedo_dir"])

    g = jax.grad(albedo)(jnp.asarray(inp.veg_ext))
    assert np.all(np.isfinite(np.asarray(g)))
    # Denser (dark) vegetation lowers the scene albedo over a brighter
    # ground in this configuration => check against finite differences
    eps = 1e-6
    fd = np.zeros_like(np.asarray(inp.veg_ext))
    for c in range(fd.shape[0]):
        for l in range(fd.shape[1]):
            pert = np.array(inp.veg_ext)
            pert[c, l] += eps
            fd[c, l] = (float(albedo(jnp.asarray(pert)))
                        - float(albedo(jnp.asarray(inp.veg_ext)))) / eps
    np.testing.assert_allclose(np.asarray(g), fd, rtol=2e-4, atol=1e-8)


def test_grad_lw_wrt_veg_ext():
    """Longwave gradient vs finite differences (urban, emission path)."""
    import __graft_entry__ as g

    from spartacus_surface_tpu.models.solver import spartacus_lw

    _, lw = g._example_inputs(C=2, L=2, S=1, dtype=np.float64)
    opt = SolverOptions(nreg=2, nstream=2, do_urban=True, n_double=6)
    lg = LegendreGauss(2)

    def loss(veg_ext):
        probe = dataclasses.replace(lw, veg_ext=veg_ext)
        internal, norm, _ = spartacus_lw(probe, opt, lg)
        return jnp.sum(internal["top_net"]) + jnp.sum(norm["ground_net"])

    x0 = jnp.asarray(lw.veg_ext)
    grad = jax.grad(loss)(x0)
    assert np.all(np.isfinite(np.asarray(grad)))
    eps = 1e-6
    base = float(loss(x0))
    fd = np.zeros_like(np.asarray(x0))
    for c in range(fd.shape[0]):
        for l in range(fd.shape[1]):
            pert = np.array(x0)
            pert[c, l] += eps
            fd[c, l] = (float(loss(jnp.asarray(pert))) - base) / eps
    np.testing.assert_allclose(np.asarray(grad), fd, rtol=5e-4,
                               atol=1e-6 * max(1.0, abs(base)))


def test_grad_nreg3_sw():
    """Shortwave gradient at the RAMI-V flagship configuration (nreg=3,
    4 streams) vs finite differences."""
    rng = np.random.default_rng(42)
    inp = make_inputs(rng, C=2, L=2, S=1, urban=True)
    opt = SolverOptions(nreg=3, nstream=4, do_urban=True, n_double=6)
    lg = LegendreGauss(4)

    def loss(veg_ext):
        probe = dataclasses.replace(inp, veg_ext=veg_ext)
        ndir, _, bc = spartacus_sw(probe, opt, lg)
        return jnp.sum(bc["top_albedo_dir"]) + jnp.sum(ndir["ground_net"])

    x0 = jnp.asarray(inp.veg_ext)
    grad = jax.grad(loss)(x0)
    assert np.all(np.isfinite(np.asarray(grad)))
    eps = 1e-6
    base = float(loss(x0))
    fd = np.zeros_like(np.asarray(x0))
    for c in range(fd.shape[0]):
        for l in range(fd.shape[1]):
            pert = np.array(x0)
            pert[c, l] += eps
            fd[c, l] = (float(loss(jnp.asarray(pert))) - base) / eps
    np.testing.assert_allclose(np.asarray(grad), fd, rtol=5e-4, atol=1e-8)


def test_grad_chunked_matches_unchunked():
    """column_chunk is a pure reshape of the batch axis, so the gradient
    through the chunked lax.map must match the whole-batch gradient."""
    rng = np.random.default_rng(3)
    inp = make_inputs(rng, C=4, L=2, S=1, urban=True)
    lg = LegendreGauss(2)

    def grad_with(chunk):
        opt = SolverOptions(nreg=2, nstream=2, do_urban=True, n_double=6,
                            column_chunk=chunk)

        def loss(veg_ext):
            probe = dataclasses.replace(inp, veg_ext=veg_ext)
            _, _, bc = spartacus_sw(probe, opt, lg)
            return jnp.sum(bc["top_albedo_dir"])

        return np.asarray(jax.grad(loss)(jnp.asarray(inp.veg_ext)))

    np.testing.assert_allclose(grad_with(2), grad_with(0),
                               rtol=1e-12, atol=1e-14)


def test_grad_through_run_radsurf():
    """Gradient through the PRODUCTION dispatcher (tile bucketing, group
    padding, fused core) with respect to a traced input field, checked
    against finite differences."""
    import __graft_entry__ as g

    from spartacus_surface_tpu.models.dispatch import run_radsurf
    from spartacus_surface_tpu.utils.config import Config

    config = Config(nsw=1, nlw=1)
    config.consolidate()
    arrays = g._example_arrays(C=4, L=2, S=1, dtype=np.float64)

    def loss(veg_ext):
        probed = dict(arrays)
        probed["veg_ext"] = veg_ext
        out = run_radsurf(config, probed)
        return (jnp.sum(out["sw_norm_dir"]["ground_net"])
                + jnp.sum(out["lw_internal"]["top_net"]))

    x0 = jnp.asarray(arrays["veg_ext"])
    grad = jax.grad(loss)(x0)
    assert np.all(np.isfinite(np.asarray(grad)))
    eps = 1e-6
    base = float(loss(x0))
    fd = np.zeros_like(np.asarray(x0))
    for c in range(fd.shape[0]):
        for l in range(fd.shape[1]):
            pert = np.array(x0)
            pert[c, l] += eps
            fd[c, l] = (float(loss(jnp.asarray(pert))) - base) / eps
    np.testing.assert_allclose(np.asarray(grad), fd, rtol=5e-4,
                               atol=1e-6 * max(1.0, abs(base)))
