"""chip_smoke.py's CPU-checkable parts: the GPU refusal, the in-process
CLI runner and output checks that bench.py shares, the memory budget a
CLI run's peak is held to, and the relative-error helper."""

import jax
import numpy as np
import pytest

import chip_smoke as smoke
from spartacus_surface_tpu.driver import synthetic_input as si
from spartacus_surface_tpu.utils import memory

GIB = 2**30


@pytest.fixture
def restore_x64():
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


def test_refuses_without_gpu(capsys):
    assert smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out


@pytest.mark.parametrize("name,ncol,precision,schema", [
    ("coupled", 12, "double", smoke.SCHEMA_COUPLED),
    ("rami", 2, "single", smoke.SCHEMA_RAMI),
])
def test_cli_runner_and_output_checks(tmp_path, monkeypatch, restore_x64,
                                      name, ncol, precision, schema):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    nam, inp = si.write_deployment(name, str(tmp_path), ncol=ncol, seed=1)
    out = str(tmp_path / "out.nc")
    phases, secs = smoke.run_cli(nam, inp, out, precision)
    assert set(phases) == {"read_input", "radsurf", "save"}
    assert all(0.0 <= t <= secs for t in phases.values())
    figures = smoke.check_output(name, out, precision, ncol, schema)
    max_bound, median_bound = smoke.CONSERVATION_BOUND[precision]
    for band in ("sw", "lw"):
        assert figures[band]["max"] <= max_bound
        assert figures[band]["median"] <= median_bound
    with pytest.raises(smoke.SmokeFailure, match="output columns"):
        smoke.check_output(name, out, precision, ncol + 1, schema)
    with pytest.raises(smoke.SmokeFailure, match="lacks"):
        smoke.check_output(name, out, precision, ncol, schema + ("nope",))


def test_conservation_flags_a_leak():
    """A column whose absorbed fluxes miss 1 % of the net top flux."""
    out = {
        "ground_flux_net_sw": np.array([60.0, 60.0]),
        "top_flux_net_sw": np.array([80.0, 80.0]),
        "top_flux_dn_sw": np.array([100.0, 100.0]),
        "veg_absorption_sw": np.array([[10.0, 10.0], [9.5, -9999.0]]),
    }
    res = smoke.conservation(out, "sw")
    np.testing.assert_allclose(res, [0.0, 0.105])


@pytest.mark.parametrize("limit_gib", [64, 4])
def test_budget_bytes(tmp_path, monkeypatch, limit_gib):
    """The budget a coupled run's peak is held to: one streamed slice's
    I/O plus the largest solve chunk of each layered tile type."""
    monkeypatch.setattr(memory, "device_bytes_limit",
                        lambda: limit_gib * GIB)
    nam, _ = si.write_deployment("coupled", str(tmp_path), ncol=6)
    d = si.DEPLOYMENTS["coupled"]
    limit = limit_gib * GIB
    io_col = memory.io_bytes_per_column(8, 1, 8)
    cols = min(d["ncol"], int(memory.IO_SHARE * limit) // io_col)
    want = cols * io_col
    tile_cols = -(-cols // 6)
    for nreg in (2, 1, 2):  # forest, urban, vegetated urban
        per_col = memory.solve_bytes_per_column(nreg, 4, 8, 1, 8)
        want += min(tile_cols,
                    int(memory.SOLVE_SHARE * limit) // per_col) * per_col
    got = smoke.budget_bytes("coupled", nam, "double")
    assert got == want
    assert got <= (memory.IO_SHARE + 3 * memory.SOLVE_SHARE) * limit


def test_max_rel_err_normalises_per_field():
    a = {"x": np.array([1.0, 200.0]), "y": np.array([0.001])}
    b = {"x": np.array([1.0, 202.0]), "y": np.array([0.0])}
    # x: 2 / 202 against its own scale; y: 0.001 / max(1, 0)
    assert smoke.max_rel_err(a, b) == pytest.approx(2.0 / 202.0)
    assert smoke.max_rel_err(b, b) == 0.0
