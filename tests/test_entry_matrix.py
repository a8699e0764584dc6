"""entry_matrix / compile_check_matrix have real callers.

The AOT compile matrix covers every (nreg, nstream) configuration of the
reference's deployments: a configuration the device compiler refuses
must surface as THIS named check, not as a dead benchmark.  On the CPU
test mesh each config is traced and lowered (which catches shape/dtype/
static-arg breakage in the full SW+LW step); the full compile on the GPU
runs both as the gpu-marked test below and as the compile phase of
chip_smoke.py and bench.py's pre-flight block, which gate their exit
codes.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as g


def test_entry_matrix_covers_bench_configs():
    """The compile matrix is the set the bench's pre-flight compiles."""
    import inspect

    import bench

    names = [name for name, _, _ in g.entry_matrix()]
    assert names == [f"nreg{r}_ns{s}" for r, s in g.ENTRY_CONFIGS]
    assert list(g.ENTRY_CONFIGS) == [(1, 2), (2, 4), (3, 4), (2, 8)]
    src = inspect.getsource(bench.main)
    assert "g.compile_check_matrix(" in src and "g.ENTRY_CONFIGS" in src


@pytest.mark.parametrize(
    "idx", range(len(g.ENTRY_CONFIGS)),
    ids=[f"nreg{r}_ns{s}" for r, s in g.ENTRY_CONFIGS],
)
def test_entry_matrix_lowers(idx):
    """Trace + lower each config on the current backend (CPU here; the
    device compile is covered on the GPU by compile_check_matrix)."""
    name, fn, args = g.entry_matrix()[idx]
    lowered = jax.jit(fn).lower(*args)
    # every matrix product asks for HIGHEST: no TF32 on the GPU
    text = lowered.as_text()
    assert "dot_general" in text and g.non_highest_dots(text) == []


@pytest.mark.parametrize(
    "idx", range(len(g.ENTRY_CONFIGS)),
    ids=[f"nreg{r}_ns{s}" for r, s in g.ENTRY_CONFIGS],
)
def test_entry_matrix_lowers_f64(idx):
    """The same matrix in double precision, the reference's default."""
    name, fn, args = g.entry_matrix(np.float64)[idx]
    assert args[0].dz.dtype == np.float64
    assert jax.jit(fn).lower(*args) is not None


@pytest.mark.gpu
def test_compile_check_matrix_on_gpu():
    """Full AOT compile of every config on the card (GPU only)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend; chip_smoke.py runs this on the card")
    for name, secs, ma in g.compile_check_matrix(verbose=False):
        assert secs > 0 and ma is not None, name


def test_dispatcher_products_highest(monkeypatch):
    """The whole run_radsurf program — every tile group, the scatters and
    the flat / simple-urban paths — asks for HIGHEST on every product."""
    import spartacus_surface_tpu.models.dispatch as D
    from spartacus_surface_tpu.utils.config import Config

    config = Config(nsw=1, nlw=1, do_save_flux_profile=True)
    config.consolidate()
    texts = []
    core = D._radsurf_core

    def spy(payloads, plan, shape, mesh=None):
        texts.append(core.lower(payloads, plan, shape, mesh).as_text())
        return core(payloads, plan, shape, mesh=mesh)

    monkeypatch.setattr(D, "_radsurf_core", spy)
    D.run_radsurf(config, g._example_arrays(C=12, L=3, S=1))
    assert "dot_general" in texts[0]
    assert g.non_highest_dots(texts[0]) == []
