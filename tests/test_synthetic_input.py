"""Seeded reference-schema inputs (driver/synthetic_input.py): every tile
type round-trips through read_input, and both predefined deployments run
end to end through the CLI with the energy budget closed."""

import numpy as np
import pytest

from spartacus_surface_tpu.driver import synthetic_input as si
from spartacus_surface_tpu.driver.main import main as cli_main
from spartacus_surface_tpu.driver.read_input import read_input
from spartacus_surface_tpu.models.dispatch import TILE_NAMES
from spartacus_surface_tpu.utils.config import Config, DriverConfig
from tests.test_reference_cases import budget_residual, read_out


@pytest.mark.parametrize("tile", sorted(TILE_NAMES),
                         ids=[TILE_NAMES[t] for t in sorted(TILE_NAMES)])
def test_roundtrip_every_tile_type(tmp_path, tile):
    C, L, S = 5, 4, 3
    fields = si.make_fields(C, L, nsw=S, tiles=(tile,), seed=tile)
    path = str(tmp_path / "in.nc")
    si.write_input(path, fields)
    nam = str(tmp_path / "config.nam")
    si.write_namelist(nam, dict(nsw=S), {})
    config = Config.from_namelist(nam).consolidate()
    data = read_input(path, config, DriverConfig.from_namelist(nam))
    arrays = data["arrays"]

    nlay = fields["nlayer"][1]
    assert (arrays["i_representation"] == tile).all()
    np.testing.assert_array_equal(arrays["nlay"], nlay)
    assert data["ncol"] == C and data["nlay_max"] == nlay.max()
    height = fields["height"][1]
    for c in range(C):
        n = nlay[c]
        np.testing.assert_allclose(arrays["dz"][c, :n],
                                   np.diff(height[c, :n + 1]))
        assert (arrays["dz"][c, :n] > 0).all()
    for key in ("veg_fraction", "building_fraction", "veg_ext"):
        np.testing.assert_allclose(arrays[key],
                                   fields[{"veg_ext": "veg_extinction"}.get(
                                       key, key)][1][:, :nlay.max()])
    assert (arrays["veg_fraction"] + arrays["building_fraction"] < 1).all()
    assert arrays["sw_veg_ssa"].shape == (C, nlay.max(), S)
    assert arrays["ground_albedo"].shape == (C, S)
    np.testing.assert_allclose(data["top_flux_dn_sw"],
                               fields["top_flux_dn_sw"][1])
    assert (data["top_flux_dn_direct_sw"] < data["top_flux_dn_sw"]).all()
    for val in arrays.values():
        assert np.isfinite(val).all()


def test_deployments_are_seeded(tmp_path):
    a = si.make_fields(12, 3, seed=7)
    b = si.make_fields(12, 3, seed=7)
    c = si.make_fields(12, 3, seed=8)
    for key in a:
        np.testing.assert_array_equal(a[key][1], b[key][1])
    assert not np.array_equal(a["veg_extinction"][1],
                              c["veg_extinction"][1])
    nam, _ = si.write_deployment("rami", str(tmp_path), ncol=2)
    config = Config.from_namelist(nam)
    assert (config.n_vegetation_region_urban, config.nsw) == (2, 14)
    assert DriverConfig.from_namelist(nam).do_conservation_check


def _run(tmp_path, name, ncol, precision, capsys):
    nam, inp = si.write_deployment(name, str(tmp_path), ncol=ncol, seed=3)
    out = str(tmp_path / "out.nc")
    assert cli_main([nam, inp, out, "--precision", precision]) == 0
    assert "Column  Ground" in capsys.readouterr().out  # budget table
    return read_out(out)


def test_cli_coupled_tiny(tmp_path, capsys, monkeypatch):
    """All six tile types through the CLI; the layered and flat tiles
    close their energy budget (the reference's simple-urban LW scheme
    does not, so those columns are left out)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    out = _run(tmp_path, "coupled", 12, "double", capsys)
    assert sorted(set(out["surface_type"])) == sorted(TILE_NAMES)
    closed = np.isin(out["surface_type"], (0, 1, 2, 3))
    for band in ("sw", "lw"):
        res = budget_residual(out, band)[closed]
        assert np.abs(res).max() < 1e-10 * np.abs(
            out[f"top_flux_dn_{band}"]).max()
        for name, val in out.items():
            if val.dtype.kind == "f":
                assert np.isfinite(val).all(), name


def test_cli_rami_tiny(tmp_path, capsys, monkeypatch):
    """The RAMI-V shape (62 layers, 14 SW bands, nreg = 3) through the
    CLI in single precision: spectral profiles written, budget closed to
    float32 rounding."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    out = _run(tmp_path, "rami", 2, "single", capsys)
    assert out["ground_spectral_flux_dn_sw"].shape == (2, 14)
    assert out["spectral_flux_dn_layer_top_sw"].shape == (2, 62, 14)
    assert out["ground_flux_net_sw"].dtype.itemsize == 4  # float32 data
    for band in ("sw", "lw"):
        res = budget_residual(out, band)
        assert np.abs(res).max() < 1e-4 * np.abs(
            out[f"top_flux_dn_{band}"]).max()
