"""Seeded generator of reference-schema input files and namelists.

Writes a NetCDF3 input file holding every variable read_input.py reads
(the schema of the reference's test/*/ inputs) plus a matching namelist,
so the CLI, the benchmark and the tests can run end to end without the
reference's own files.  Everything is drawn from numpy's generator for
--seed; nothing is downloaded.

Two deployments are predefined (DEPLOYMENTS):

  coupled  the reference's purpose: a host atmosphere model hands over
           many columns of every tile type in equal shares, 8 layers,
           one SW and one LW band, the reference-default namelist (one
           vegetation region, 4 streams);
  rami     the RAMI-V scene shape of the reference's test/rami5: 62
           layers, 14 SW bands, vegetated-urban tiles with the trees'
           trunks as buildings, two vegetation regions (nreg = 3), 4
           streams, spectral flux profiles saved.

Usage:
  python -m spartacus_surface_tpu.driver.synthetic_input coupled DIR \
      [--ncol N] [--seed S]
writes DIR/config.nam and DIR/input.nc.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from scipy.io import netcdf_file

from ..models.dispatch import (
    TILE_FLAT,
    TILE_FOREST,
    TILE_INFINITE_STREET,
    TILE_SIMPLE_URBAN,
    TILE_URBAN,
    TILE_VEGETATED_URBAN,
)
from .duplicate_profiles import DEFAULT_COS_SZA

ALL_TILES = (TILE_FLAT, TILE_FOREST, TILE_URBAN, TILE_VEGETATED_URBAN,
             TILE_SIMPLE_URBAN, TILE_INFINITE_STREET)

DEPLOYMENTS = {
    "coupled": dict(
        ncol=131072, nlay=8, nsw=1, nlw=1, tiles=ALL_TILES, trunks=False,
        radsurf=dict(n_vegetation_region_forest=1,
                     n_vegetation_region_urban=1),
        driver=dict(do_conservation_check=True),
    ),
    "rami": dict(
        ncol=50048, nlay=62, nsw=14, nlw=1, tiles=(TILE_VEGETATED_URBAN,),
        trunks=True,
        radsurf=dict(n_vegetation_region_urban=2,
                     do_save_spectral_flux=True, do_save_flux_profile=True),
        driver=dict(do_conservation_check=True),
    ),
}


def _fmt(val) -> str:
    if isinstance(val, bool):
        return "true" if val else "false"
    return repr(val)


def write_namelist(path: str, radsurf: dict, driver: dict,
                   iverbose: int = 2) -> None:
    """Write a &radsurf / &radsurf_driver namelist file."""
    with open(path, "w") as f:
        for group, entries in (("radsurf", {"iverbose": iverbose, **radsurf}),
                               ("radsurf_driver", {"iverbose": iverbose,
                                                   **driver})):
            f.write(f"&{group}\n")
            for key, val in entries.items():
                f.write(f"  {key} = {_fmt(val)},\n")
            f.write("/\n")


def make_fields(ncol: int, nlay: int, nsw: int = 1, nlw: int = 1,
                tiles=ALL_TILES, trunks: bool = False,
                seed: int = 0) -> dict:
    """{name: (dims, array)} for one input file; tiles are assigned in
    equal shares, cycling through `tiles`."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape)
    C, L = ncol, nlay
    rep = np.resize(np.asarray(tiles, np.int32), C)
    layered = np.isin(rep, (TILE_FOREST, TILE_URBAN, TILE_VEGETATED_URBAN))
    simple = np.isin(rep, (TILE_SIMPLE_URBAN, TILE_INFINITE_STREET))
    nlayer = np.where(layered, L, np.where(simple, 1, 0)).astype(np.int32)
    has_bld = np.isin(rep, (TILE_URBAN, TILE_VEGETATED_URBAN,
                            TILE_SIMPLE_URBAN, TILE_INFINITE_STREET))
    has_veg = np.isin(rep, (TILE_FOREST, TILE_VEGETATED_URBAN))

    # Real layers split the canopy unevenly; layers beyond nlayer (and
    # every layer of a flat tile) have zero thickness and are never read.
    top = u(20.0, 30.0, C) if trunks else u(5.0, 40.0, C)
    w = u(0.5, 1.5, C, L) * (np.arange(L)[None, :] < nlayer[:, None])
    dz = top[:, None] * w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
    height = np.concatenate([np.zeros((C, 1)), np.cumsum(dz, axis=1)], 1)

    if trunks:
        # Trunks as buildings: thin cylinders below and through the crown
        bf = np.where(has_bld[:, None], u(0.002, 0.01, C, L), 0.0)
        bscale = u(0.2, 0.5, C, L)
        crown = np.arange(L)[None, :] >= (L * u(0.3, 0.5, C))[:, None]
        vf = np.where(has_veg[:, None] & crown, u(0.3, 0.9, C, L), 0.0)
        vext = u(0.2, 1.0, C, L)
        vscale = u(1.0, 5.0, C, L)
    else:
        bf = np.where(has_bld[:, None],
                      -np.sort(-u(0.1, 0.6, C, L), axis=1), 0.0)
        bscale = u(10.0, 50.0, C, L)
        vf = np.where(has_veg[:, None], u(0.1, 0.8, C, L), 0.0)
        vf = np.minimum(vf, 0.95 * (1.0 - bf))
        vext = u(0.05, 0.5, C, L)
        vscale = u(2.0, 20.0, C, L)

    tair = u(270.0, 305.0, C)
    air_t = tair[:, None] - 0.0065 * 0.5 * (height[:, 1:] + height[:, :-1])
    # Leaf single-scattering albedo: dark in the visible, bright in the
    # near infrared (the first third of the SW bands is visible)
    vis = np.arange(nsw) < max(1, nsw // 3)
    leaf = np.where(vis, 0.15, 0.85) if nsw > 1 else np.array([0.5])
    veg_sw_ssa = leaf + u(-0.05, 0.05, C, L, nsw)
    ground_sw = (np.where(vis, 0.08, 0.25) if nsw > 1
                 else np.array([0.15])) + u(-0.05, 0.05, C, nsw)
    top_sw = u(50.0, 1000.0, C, nsw) / nsw

    if trunks:
        cos_sza = np.tile(DEFAULT_COS_SZA, C // len(DEFAULT_COS_SZA) + 1)[:C]
    else:
        cos_sza = u(0.05, 1.0, C)

    c, cl = ("column",), ("column", "layer")
    return {
        "surface_type": (c, rep),
        "nlayer": (c, nlayer),
        "cos_solar_zenith_angle": (c, cos_sza),
        "height": (("column", "layer_interface"), height),
        "building_fraction": (cl, bf),
        "building_scale": (cl, bscale),
        "veg_fraction": (cl, vf),
        "veg_extinction": (cl, vext),
        "veg_scale": (cl, vscale),
        "veg_fsd": (cl, u(0.5, 1.0, C, L)),
        "ground_temperature": (c, tair + u(-2.0, 8.0, C)),
        "roof_temperature": (cl, air_t + u(-2.0, 10.0, C, L)),
        "wall_temperature": (cl, air_t + u(-2.0, 6.0, C, L)),
        "air_temperature": (cl, air_t),
        "veg_temperature": (cl, air_t + u(-1.0, 2.0, C, L)),
        "ground_lw_emissivity": (c, u(0.9, 0.99, C)),
        "roof_lw_emissivity": (cl, u(0.85, 0.95, C, L)),
        "wall_lw_emissivity": (cl, u(0.85, 0.95, C, L)),
        "veg_lw_ssa": (cl, u(0.03, 0.1, C, L)),
        "top_flux_dn_lw": (c, u(200.0, 420.0, C)),
        "ground_sw_albedo": (("column", "band_sw"), ground_sw),
        "roof_sw_albedo": (cl, u(0.1, 0.3, C, L)),
        "wall_sw_albedo": (cl, u(0.1, 0.4, C, L)),
        "wall_sw_specular_fraction": (cl, u(0.0, 0.3, C, L)),
        "veg_sw_ssa": (("column", "layer", "band_sw"), veg_sw_ssa),
        "top_flux_dn_sw": (("column", "band_sw"), top_sw),
        "top_flux_dn_direct_sw": (("column", "band_sw"),
                                  top_sw * u(0.5, 0.9, C, nsw)),
    }


def write_input(path: str, fields: dict) -> None:
    """Write make_fields output as a NetCDF3 (64-bit offset) file."""
    f = netcdf_file(path, "w", version=2)
    for dims, data in fields.values():
        for name, size in zip(dims, np.shape(data)):
            if name not in f.dimensions:
                f.createDimension(name, size)
    for name, (dims, data) in fields.items():
        data = np.asarray(data)
        kind = "i" if np.issubdtype(data.dtype, np.integer) else "d"
        f.createVariable(name, kind, dims)[:] = data
    f.close()


def write_deployment(name: str, directory: str, ncol: int | None = None,
                     seed: int = 0) -> tuple:
    """Write DIR/config.nam and DIR/input.nc for a DEPLOYMENTS entry;
    returns (namelist path, input path)."""
    d = DEPLOYMENTS[name]
    os.makedirs(directory, exist_ok=True)
    nam = os.path.join(directory, "config.nam")
    inp = os.path.join(directory, "input.nc")
    write_namelist(nam, dict(nsw=d["nsw"], nlw=d["nlw"], **d["radsurf"]),
                   d["driver"])
    write_input(inp, make_fields(
        ncol or d["ncol"], d["nlay"], d["nsw"], d["nlw"],
        d["tiles"], d["trunks"], seed))
    return nam, inp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("deployment", choices=sorted(DEPLOYMENTS))
    p.add_argument("directory")
    p.add_argument("--ncol", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    nam, inp = write_deployment(a.deployment, a.directory, a.ncol, a.seed)
    print(nam)
    print(inp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
