"""Fast unit tests for the round-5 production-CLI surfaces: typed NetCDF
attributes, 100+-rank shard discovery, the auto-stream chunk picker, and
the conservation-budget summary/table split."""

import numpy as np
import pytest

from spartacus_surface_tpu.driver.main import _auto_stream_chunk
from spartacus_surface_tpu.driver.merge import find_shards
from spartacus_surface_tpu.models import flux_utils
from spartacus_surface_tpu.utils import netcdf_c
from spartacus_surface_tpu.utils.netcdf_c import NativeFile


@pytest.mark.skipif(not netcdf_c.available(), reason="libnetcdf missing")
def test_native_attribute_types_roundtrip(tmp_path):
    """Integer/float/string attributes keep their Python types through the
    native writer+reader (merge re-writes attributes, so a float64
    coercion would silently change the merged file's types)."""
    path = str(tmp_path / "attrs.nc")
    f = NativeFile(path, "w", netcdf4=True)
    f.define_dimension("x", 2)
    f.define_variable("v", ("x",), np.float64, long_name="n", count=7,
                      scale=1.5)
    f.put_attribute(None, "gatt_int", 42)
    f.put_attribute(None, "gatt_arr", np.array([1, 2, 3]))
    f.put_attribute(None, "gatt_f", 2.5)
    f.put("v", np.arange(2.0))
    f.close()
    g = NativeFile(path, "r")
    va, ga = g.attributes("v"), g.attributes()
    g.close()
    assert va["count"] == 7 and isinstance(va["count"], int)
    assert isinstance(va["scale"], float) and va["scale"] == 1.5
    assert va["long_name"] == "n"
    assert ga["gatt_int"] == 42 and isinstance(ga["gatt_int"], int)
    assert ga["gatt_arr"].dtype == np.int64
    assert np.array_equal(ga["gatt_arr"], [1, 2, 3])
    assert ga["gatt_f"] == 2.5


def test_find_shards_hundreds_of_ranks(tmp_path):
    """Autodiscovery handles 3-digit ranks and sorts numerically (the
    driver writes p{pid:02d}, which grows past two digits at 100+
    processes)."""
    out = tmp_path / "OUT.nc"
    n = 120
    for pid in range(n):
        (tmp_path / f"OUT.nc.p{pid:02d}").write_bytes(b"x")
    found = find_shards(str(out))
    assert len(found) == n
    assert found[0].endswith(".p00") and found[-1].endswith(".p119")
    # numeric, not lexical: p20 sorts before p100
    assert found.index(str(out) + ".p20") < found.index(str(out) + ".p100")


def test_find_shards_noncontiguous_rejected(tmp_path):
    (tmp_path / "O.nc.p00").write_bytes(b"x")
    (tmp_path / "O.nc.p02").write_bytes(b"x")
    with pytest.raises(FileNotFoundError, match="not contiguous"):
        find_shards(str(tmp_path / "O.nc"))


class _Cfg:
    do_sw = True
    do_lw = False
    nswinternal = 14
    nlwinternal = 1


def test_auto_stream_chunk():
    from spartacus_surface_tpu.utils import memory

    cfg = _Cfg()
    arrays = {"dz": np.zeros((1, 40))}
    per_col = memory.io_bytes_per_column(40, 14, 4)
    # a limit whose IO share holds exactly 10000 such columns
    limit = int(10000 * per_col / memory.IO_SHARE) + 1
    # no device limit (the CPU backend): never streams
    assert _auto_stream_chunk(cfg, arrays, 50048, 1, None, 4) == 0
    # below the share: no streaming
    assert _auto_stream_chunk(cfg, arrays, 10000, 1, limit, 4) == 0
    # 50048 x 40 x 14: streams, chunk divides ncol evenly, slice in budget
    ck = _auto_stream_chunk(cfg, arrays, 50048, 1, limit, 4)
    assert ck > 0 and 50048 % ck == 0 and ck <= 10000
    # a mesh splits every buffer over its devices
    assert _auto_stream_chunk(cfg, arrays, 50048, 8, limit, 4) == 0
    # double precision halves the slice
    assert _auto_stream_chunk(cfg, arrays, 10000, 1, limit, 8) == 5000
    # prime ncol: falls back to ceil split
    assert 0 < _auto_stream_chunk(cfg, arrays, 50023, 1, limit, 4) <= 10000


def test_budget_summary_vs_table(capsys):
    """check_flux prints the reference-format table up to 1000 columns and
    a worst/mean summary beyond; both return the same residuals."""
    C = 4
    rng = np.random.default_rng(0)
    flux = {
        "ground_net": rng.uniform(size=(C, 2)),
        "top_net": rng.uniform(size=(C, 2)),
        "clear_air_abs": rng.uniform(size=(C, 3, 2)),
        "wall_net": rng.uniform(size=(C, 3, 2)),
        "roof_net": rng.uniform(size=(C, 3, 2)),
        "veg_abs": rng.uniform(size=(C, 3, 2)),
        "veg_air_abs": rng.uniform(size=(C, 3, 2)),
    }
    arrays = {"i_representation": np.array([0, 1, 2, 3])}
    res_table = flux_utils.check_flux(flux, arrays, "sw")
    out_table = capsys.readouterr().out
    assert "Column  Ground" in out_table
    res_sum = flux_utils.check_flux(flux, arrays, "sw", max_table_columns=2)
    out_sum = capsys.readouterr().out
    assert "max |residual|" in out_sum and "mean |residual|" in out_sum
    np.testing.assert_allclose(res_table, res_sum)
    # components match the direct reduction for a flat column (index 0):
    # no canopy/urban/veg terms
    flat = (flux["ground_net"][0].sum() - flux["top_net"][0].sum())
    np.testing.assert_allclose(res_table[0], flat)
