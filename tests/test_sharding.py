"""Multi-device column sharding: results must equal the single-device run
and the jitted step must execute over an 8-virtual-device mesh
(conftest.py forces xla_force_host_platform_device_count=8).
"""

import numpy as np
import jax
import pytest

from spartacus_surface_tpu.models.solver import SolverOptions, spartacus_sw
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu.parallel.mesh import make_mesh, shard_inputs_by_column
from tests.test_solver_conservation import make_inputs

pytestmark = pytest.mark.slow


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_sharded_equals_single_device():
    rng = np.random.default_rng(77)
    inp = make_inputs(rng, C=16, L=3, S=2, urban=True)
    opt = SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)

    ref_dir, ref_diff, ref_bc = spartacus_sw(inp, opt, lg)

    mesh = make_mesh(8)
    sharded = shard_inputs_by_column(inp, mesh)
    sh_dir, sh_diff, sh_bc = spartacus_sw(sharded, opt, lg)

    for key in ref_dir:
        np.testing.assert_allclose(
            np.asarray(ref_dir[key]), np.asarray(sh_dir[key]),
            rtol=1e-12, atol=1e-12, err_msg=key,
        )
    for key in ref_bc:
        np.testing.assert_allclose(
            np.asarray(ref_bc[key]), np.asarray(sh_bc[key]),
            rtol=1e-12, atol=1e-12, err_msg=key,
        )
    # The output really is sharded over the mesh
    assert len(sh_dir["ground_dn"].sharding.device_set) == 8


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert all(np.isfinite(np.asarray(o)).all() for o in out)
