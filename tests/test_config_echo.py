"""Config echo at iverbose >= 2 through the real CLI.

Parity target: radsurf_config.F90:275-362 (print_config called by the
driver after consolidate).  The echo must show the CONSOLIDATED values —
streams, regions, flags — for the reference's test/simple namelist
(its settings are written out below).  Fast by design: the input file
deliberately lacks the required variables, so the CLI prints the echo,
then fails input reading with a clean error (rc = 1), never reaching the
solver.
"""

import os
import subprocess
import sys

import numpy as np
from scipy.io import netcdf_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The settings of the reference's test/simple/config.nam
SIMPLE_CONFIG = """&radsurf
  do_sw = true,
  do_lw = true,
  n_vegetation_region_forest = 2,
  n_vegetation_region_urban = 2,
  n_stream_sw_forest = 2,
  n_stream_lw_forest = 2,
  n_stream_sw_urban = 2,
  n_stream_lw_urban = 2,
  nsw = 1,
  nlw = 1,
/
&radsurf_driver
  do_conservation_check = true,
/
"""


def test_cli_config_echo_contains_consolidated_values(tmp_path):
    cfg = tmp_path / "config.nam"
    cfg.write_text(SIMPLE_CONFIG)
    bogus = tmp_path / "empty.nc"
    f = netcdf_file(str(bogus), "w")
    f.createDimension("column", 1)
    v = f.createVariable("unrelated", "d", ("column",))
    v[:] = np.zeros(1)
    f.close()

    res = subprocess.run(
        [sys.executable, "-m", "spartacus_surface_tpu.driver.main",
         "--platform=cpu", str(cfg), str(bogus), str(tmp_path / "out.nc")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    )
    assert res.returncode == 1
    assert "Error reading" in res.stderr
    out = res.stdout

    # ~12 key lines of the consolidated config for test/simple/config.nam
    # (do_sw/do_lw true, nsw=nlw=1, 2 vegetation regions, 2 streams,
    # conservation-relevant flags) — radsurf_config.F90:275-362 analogue.
    expected = [
        "Do shortwave (SW) calculations ON",
        "Do longwave (LW) calculations ON",
        "Number of SW spectral intervals = 1",
        "Number of LW spectral intervals = 1",
        "Number of vegetation regions = 2",
        "SW diffuse streams per hemisphere = 2",
        "LW streams per hemisphere = 2",
        "Use symmetric vegetation scale ON",
        "Vegetation isolation factor = 0",
        "Minimum vegetation fraction = 1e-06",
        "Minimum building fraction = 1e-06",
        "Save broadband fluxes ON",
    ]
    for line in expected:
        assert line in out, f"echo missing: {line!r}\n--- stdout ---\n{out}"
    # Settings appear for BOTH tile families (forest and urban sections)
    assert "Settings for forests:" in out
    assert "Settings for urban areas:" in out
