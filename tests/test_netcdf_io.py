"""NetCDF I/O tests: scipy classic path + native libnetcdf NetCDF4 path."""

import numpy as np
import pytest

from spartacus_surface_tpu.utils import netcdf_c
from spartacus_surface_tpu.utils.netcdf_io import InputFile, OutputFile


def _classic_input(tmp_path, ncol=4, nlay=8):
    """A reference-schema NetCDF3 input (driver/synthetic_input.py)."""
    from spartacus_surface_tpu.driver.synthetic_input import (make_fields,
                                                               write_input)

    fields = make_fields(ncol, nlay, tiles=(1,), seed=0)
    fields["cos_solar_zenith_angle"] = (("column",), np.full(ncol, 0.5))
    path = str(tmp_path / "in.nc")
    write_input(path, fields)
    return path


def test_read_reference_classic(tmp_path):
    with InputFile(_classic_input(tmp_path)) as f:
        assert f.exists("cos_solar_zenith_angle")
        assert not f.exists("no_such_variable")
        assert f.rank("height") == 2
        np.testing.assert_allclose(f.get("cos_solar_zenith_angle"), 0.5)
        assert f.dimensions()["column"] == 4


@pytest.mark.skipif(not netcdf_c.available(), reason="libnetcdf missing")
def test_native_netcdf4_roundtrip(tmp_path):
    path = str(tmp_path / "out4.nc")
    with OutputFile(path, is_hdf5_file=True) as out:
        out.define_dimension("column", 3)
        out.define_dimension("layer", 2)
        out.put_global_attributes(title_str="t", source_str="s")
        out.define_variable("flux", ("column", "layer"), units="W m-2",
                            fill_value=-9999.0)
        out.define_variable("surface_type", ("column",), dtype="h")
        out.put("flux", np.arange(6.0).reshape(3, 2))
        out.put("surface_type", np.array([0, 1, 2], np.int16))
    # HDF5 magic
    assert open(path, "rb").read(4) == b"\x89HDF"
    with InputFile(path) as f:
        np.testing.assert_allclose(
            f.get("flux"), np.arange(6.0).reshape(3, 2)
        )
        np.testing.assert_array_equal(f.get("surface_type", np.int64),
                                      [0, 1, 2])
        assert f.dimensions() == {"column": 3, "layer": 2}


@pytest.mark.skipif(not netcdf_c.available(), reason="libnetcdf missing")
def test_native_reads_classic_too(tmp_path):
    f = netcdf_c.NativeFile(_classic_input(tmp_path))
    assert f.dimensions()["layer"] == 8
    assert f.var_dimensions("height") == ("column", "layer_interface")
    f.close()
