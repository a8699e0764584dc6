"""Tile-type dispatch: buckets columns by representation and runs every
group's batched solver inside ONE jitted program.

Parity: the per-column `select case (i_representation)` loop of
radsurf/radsurf_interface.F90:105-313, replaced by static column bucketing
(the representation vector is static input data).  Each group is gathered
host-side, then a single fused jit solves all groups (flat analytic,
layered SPARTACUS forest/urban, simple-urban 2x2) and scatters their
outputs into dense device-resident [C, ...] arrays with `at[idx].set` —
no host round-trips between groups, and XLA is free to overlap the group
computations in one compilation unit.

Device-mesh execution: pass `mesh=` (a 1-D jax.sharding Mesh over the
column axis, parallel/mesh.py) and every group's inputs are padded to a
device multiple and sharded along columns before the fused solve — the
equivalent of the reference's OpenMP block loop
(driver/spartacus_surface_driver.F90:199-234).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.legendre_gauss import LegendreGauss
from ..utils.config import Config
from . import flat as flat_mod
from . import simple_urban as su_mod
from .solver import CanopyInputs, SolverOptions, spartacus_lw, spartacus_sw

# Tile representation codes (radsurf/radsurf_canopy_properties.F90:26-33)
TILE_FLAT = 0
TILE_FOREST = 1
TILE_URBAN = 2
TILE_VEGETATED_URBAN = 3
TILE_SIMPLE_URBAN = 4
TILE_INFINITE_STREET = 5

TILE_NAMES = {
    TILE_FLAT: "Flat",
    TILE_FOREST: "Forest",
    TILE_URBAN: "Urban",
    TILE_VEGETATED_URBAN: "VegetatedUrban",
    TILE_SIMPLE_URBAN: "SimpleUrban",
    TILE_INFINITE_STREET: "InfiniteStreet",
}

_COL_FIELDS = ("ground_dn", "ground_dn_dir", "ground_net",
               "ground_vertical_diff", "top_dn", "top_dn_dir", "top_net")
_LAY_FIELDS = ("roof_in", "roof_in_dir", "roof_net", "wall_in", "wall_in_dir",
               "wall_net", "clear_air_abs", "veg_abs", "veg_air_abs",
               "veg_abs_dir", "flux_dn_layer_top", "flux_dn_dir_layer_top",
               "flux_up_layer_top", "flux_dn_layer_base",
               "flux_dn_dir_layer_base", "flux_up_layer_base")
_SCAL_COL_FIELDS = ("ground_sunlit_frac",)
_SCAL_LAY_FIELDS = ("roof_sunlit_frac", "wall_sunlit_frac", "veg_sunlit_frac")


def empty_flux(ncol, nlay, nspec, dtype=np.float64):
    """Dense canopy-flux container, host numpy (cf. canopy_flux_type,
    radsurf/radsurf_canopy_flux.F90:27-91).  Kept for oracle harnesses;
    the fused dispatch uses the jnp twin below."""
    out = {}
    for key in _COL_FIELDS:
        out[key] = np.zeros((ncol, nspec), dtype)
    for key in _LAY_FIELDS:
        out[key] = np.zeros((ncol, nlay, nspec), dtype)
    for key in _SCAL_COL_FIELDS:
        out[key] = np.zeros((ncol,), dtype)
    for key in _SCAL_LAY_FIELDS:
        out[key] = np.zeros((ncol, nlay), dtype)
    return out


def _empty_flux_jnp(ncol, nlay, nspec, dtype):
    out = {}
    for key in _COL_FIELDS:
        out[key] = jnp.zeros((ncol, nspec), dtype)
    for key in _LAY_FIELDS:
        out[key] = jnp.zeros((ncol, nlay, nspec), dtype)
    for key in _SCAL_COL_FIELDS:
        out[key] = jnp.zeros((ncol,), dtype)
    for key in _SCAL_LAY_FIELDS:
        out[key] = jnp.zeros((ncol, nlay), dtype)
    return out


def _scatter(dst: dict, src: dict, idx, n, sun_up=None, layer0=False):
    """Scatter a solver-group's first-n outputs into the dense containers
    (functional at[].set so everything stays on device).

    sun_up: optional [n] bool; rows with sun below the horizon are zeroed
    (the reference skips the SW solve entirely then,
    radsurf_interface.F90:183,217,248).
    layer0: simple-urban outputs have no layer axis; per-layer fields are
    written to layer 0.
    """
    for key, val in src.items():
        if key not in dst:
            continue
        v = val[:n]
        if sun_up is not None:
            mask = sun_up.reshape((-1,) + (1,) * (v.ndim - 1))
            v = jnp.where(mask, v, 0.0)
        if layer0 and (key in _LAY_FIELDS or key in _SCAL_LAY_FIELDS):
            dst[key] = dst[key].at[idx, 0].set(v)
        else:
            dst[key] = dst[key].at[idx].set(v)


def _gather_inputs(arrays: dict, idx, spectral_prefix: str,
                   use_sw_direct_albedo: bool = True) -> CanopyInputs:
    """Build a CanopyInputs pytree (host numpy) for the columns in `idx`."""
    a = arrays

    def g(key):
        return _take(a.get(key), idx)

    common = dict(
        dz=g("dz"),
        cos_sza=g("cos_sza"),
        veg_fraction=g("veg_fraction"),
        veg_scale=g("veg_scale"),
        veg_ext=g("veg_ext"),
        veg_fsd=g("veg_fsd"),
        veg_contact_fraction=g("veg_contact_fraction"),
        building_fraction=g("building_fraction"),
        building_scale=g("building_scale"),
    )
    if spectral_prefix == "sw":
        galb = g("ground_albedo")
        return CanopyInputs(
            air_ext=g("sw_air_ext"),
            air_ssa=g("sw_air_ssa"),
            veg_ssa=g("sw_veg_ssa"),
            ground_albedo=galb,
            ground_albedo_dir=(
                g("ground_albedo_dir") if use_sw_direct_albedo else galb
            ),
            roof_albedo=g("roof_albedo"),
            roof_albedo_dir=g("roof_albedo_dir"),
            wall_albedo=g("wall_albedo"),
            wall_specular_frac=g("wall_specular_frac"),
            **common,
        )
    return CanopyInputs(
        air_ext=g("lw_air_ext"),
        air_ssa=g("lw_air_ssa"),
        veg_ssa=g("lw_veg_ssa"),
        ground_emissivity=g("ground_emissivity"),
        ground_emission=g("ground_emission"),
        roof_emissivity=g("roof_emissivity"),
        roof_emission=g("roof_emission"),
        wall_emissivity=g("wall_emissivity"),
        wall_emission=g("wall_emission"),
        clear_air_planck=g("clear_air_planck"),
        veg_planck=g("veg_planck"),
        veg_air_planck=g("veg_air_planck"),
        **common,
    )


def _solver_groups(config: Config):
    """(tile codes) -> (SolverOptions kwargs, lg_sw, lg_lw) for the layered
    SPARTACUS tile types."""
    return {
        TILE_FOREST: (
            dict(
                nreg=config.n_vegetation_region_forest + 1,
                nstream=None,  # filled per band
                do_urban=False,
                use_symmetric_vegetation_scale=(
                    config.use_symmetric_vegetation_scale_forest
                ),
                vegetation_isolation_factor=(
                    config.vegetation_isolation_factor_forest
                ),
                min_vegetation_fraction=config.min_vegetation_fraction,
                min_building_fraction=config.min_building_fraction,
                n_double=config.n_double,
                column_chunk=config.column_chunk,
            ),
            config.lg_sw_forest,
            config.lg_lw_forest,
        ),
        TILE_URBAN: (
            dict(
                nreg=1,
                nstream=None,
                do_urban=True,
                use_symmetric_vegetation_scale=(
                    config.use_symmetric_vegetation_scale_urban
                ),
                vegetation_isolation_factor=(
                    config.vegetation_isolation_factor_urban
                ),
                min_vegetation_fraction=config.min_vegetation_fraction,
                min_building_fraction=config.min_building_fraction,
                n_double=config.n_double,
                column_chunk=config.column_chunk,
            ),
            config.lg_sw_urban,
            config.lg_lw_urban,
        ),
        TILE_VEGETATED_URBAN: (
            dict(
                nreg=config.n_vegetation_region_urban + 1,
                nstream=None,
                do_urban=True,
                use_symmetric_vegetation_scale=(
                    config.use_symmetric_vegetation_scale_urban
                ),
                vegetation_isolation_factor=(
                    config.vegetation_isolation_factor_urban
                ),
                min_vegetation_fraction=config.min_vegetation_fraction,
                min_building_fraction=config.min_building_fraction,
                n_double=config.n_double,
                column_chunk=config.column_chunk,
            ),
            config.lg_sw_urban,
            config.lg_lw_urban,
        ),
    }


def _take(val, idx):
    """Gather columns: host numpy indexing for host arrays (the cheap
    production path), jnp gather for jax arrays/tracers so run_radsurf
    stays differentiable with respect to traced input fields."""
    if val is None:
        return None
    if isinstance(val, np.ndarray):
        return val[idx]
    import jax.numpy as jnp

    return jnp.asarray(val)[idx]


def _pad_group(payload, n: int, npad: int):
    """Edge-replicate the last column of every payload leaf up to npad
    (a valid column, so solvers are numerically safe on the padding;
    its outputs are sliced away before the scatter)."""
    if npad == n:
        return payload

    def f(x):
        if not isinstance(x, np.ndarray) and not np.isscalar(x):
            import jax.numpy as jnp

            x = jnp.asarray(x)
            return jnp.concatenate(
                [x, jnp.repeat(x[-1:], npad - n, axis=0)], axis=0
            )
        x = np.asarray(x)
        return np.concatenate(
            [x, np.repeat(x[-1:], npad - n, axis=0)], axis=0
        )

    return jax.tree_util.tree_map(f, payload)


@functools.partial(jax.jit, static_argnames=("plan", "shape", "mesh"))
def _radsurf_core(payloads, plan, shape, mesh=None):
    """The fused dispatcher: one compilation unit for every tile group.

    plan: static tuple of group specs; payloads: matching tuple of traced
    input pytrees (already padded/sharded by the caller); mesh: when
    given, the layered-solver groups run under jax.shard_map over the
    column axis, so column chunking (SolverOptions.column_chunk,
    including AUTO) applies PER SHARD — each device bounds its own
    working set, as an unsharded run does.
    """
    (ncol, nlay, nsw, nlw, do_sw, do_lw, with_profiles, dtype_str) = shape
    dtype = np.dtype(dtype_str)

    out = {}
    bc = {}
    if do_sw:
        out["sw_norm_dir"] = _empty_flux_jnp(ncol, nlay, nsw, dtype)
        out["sw_norm_diff"] = _empty_flux_jnp(ncol, nlay, nsw, dtype)
        bc["sw_albedo"] = jnp.zeros((ncol, nsw), dtype)
        bc["sw_albedo_dir"] = jnp.zeros((ncol, nsw), dtype)
    if do_lw:
        out["lw_internal"] = _empty_flux_jnp(ncol, nlay, nlw, dtype)
        out["lw_norm"] = _empty_flux_jnp(ncol, nlay, nlw, dtype)
        bc["lw_emissivity"] = jnp.zeros((ncol, nlw), dtype)
        bc["lw_emission"] = jnp.zeros((ncol, nlw), dtype)

    for spec, pl in zip(plan, payloads):
        kind, n = spec[0], spec[1]
        idx = pl["idx"]

        if kind == "flat":
            # radsurf_interface.F90:122-173
            if do_sw:
                nd, nf, fbc = flat_mod.flat_sw(pl["galb"], pl["galb_dir"])
                _scatter(out["sw_norm_dir"], nd, idx, n)
                _scatter(out["sw_norm_diff"], nf, idx, n)
                bc["sw_albedo"] = bc["sw_albedo"].at[idx].set(
                    fbc["sw_albedo"][:n])
                bc["sw_albedo_dir"] = bc["sw_albedo_dir"].at[idx].set(
                    fbc["sw_albedo_dir"][:n])
            if do_lw:
                li, ln, fbc = flat_mod.flat_lw(pl["gemis"], pl["gemit"])
                _scatter(out["lw_internal"], li, idx, n)
                _scatter(out["lw_norm"], ln, idx, n)
                bc["lw_emissivity"] = bc["lw_emissivity"].at[idx].set(
                    fbc["lw_emissivity"][:n])
                bc["lw_emission"] = bc["lw_emission"].at[idx].set(
                    fbc["lw_emission"][:n])

        elif kind == "spartacus":
            _, n, opt_sw, opt_lw, lg_sw, lg_lw = spec

            def solve(fn, opt, lg):
                if mesh is None:
                    return lambda a: fn(a, opt, lg,
                                        with_profiles=with_profiles)
                from jax.sharding import PartitionSpec as P

                # Per-shard execution: every [C, ...] leaf is split over
                # the column axis; the solver (and its column_chunk
                # streaming) runs independently per device.
                # check_vma off: scan carries start from replicated
                # zeros, which the varying-axis analysis rejects; the
                # solver is collective-free so the check buys nothing.
                return jax.shard_map(
                    lambda a: fn(a, opt, lg, with_profiles=with_profiles),
                    mesh=mesh, in_specs=P("columns"),
                    out_specs=P("columns"), check_vma=False,
                )

            if do_sw:
                ndir, ndiff, sbc = solve(spartacus_sw, opt_sw, lg_sw)(
                    pl["sw"]
                )
                sun_up = pl["cos_sza"][:n] > 0.0
                _scatter(out["sw_norm_dir"], ndir, idx, n, sun_up)
                _scatter(out["sw_norm_diff"], ndiff, idx, n, sun_up)
                bc["sw_albedo"] = bc["sw_albedo"].at[idx].set(
                    sbc["top_albedo_diff"][:n])
                bc["sw_albedo_dir"] = bc["sw_albedo_dir"].at[idx].set(
                    sbc["top_albedo_dir"][:n])
            if do_lw:
                lint, lnorm, lbc = solve(spartacus_lw, opt_lw, lg_lw)(
                    pl["lw"]
                )
                _scatter(out["lw_internal"], lint, idx, n)
                _scatter(out["lw_norm"], lnorm, idx, n)
                bc["lw_emissivity"] = bc["lw_emissivity"].at[idx].set(
                    lbc["top_emissivity"][:n])
                bc["lw_emission"] = bc["lw_emission"].at[idx].set(
                    lbc["top_emission"][:n])

        elif kind == "simple":
            # radsurf_interface.F90:272-309
            _, n, min_bf = spec
            if do_sw:
                ndir, ndiff, sbc = su_mod.simple_urban_sw(
                    pl["dz"], pl["bf"], pl["bs"], pl["cos_sza"],
                    pl["is_inf"], pl["galb"], pl["galb_dir"],
                    pl["ralb"], pl["walb"],
                    min_building_fraction=min_bf,
                    with_profiles=with_profiles,
                )
                sun_up = pl["cos_sza"][:n] > 0.0
                _scatter(out["sw_norm_dir"], ndir, idx, n, sun_up,
                         layer0=True)
                _scatter(out["sw_norm_diff"], ndiff, idx, n, sun_up,
                         layer0=True)
                bc["sw_albedo"] = bc["sw_albedo"].at[idx].set(
                    sbc["sw_albedo"][:n])
                bc["sw_albedo_dir"] = bc["sw_albedo_dir"].at[idx].set(
                    sbc["sw_albedo_dir"][:n])
            if do_lw:
                lint, lnorm, lbc = su_mod.simple_urban_lw(
                    pl["dz"], pl["bf"], pl["bs"], pl["is_inf"],
                    pl["gemis"], pl["gemit"],
                    pl["remis"], pl["remit"],
                    pl["wemis"], pl["wemit"],
                    min_building_fraction=min_bf,
                    with_profiles=with_profiles,
                )
                _scatter(out["lw_internal"], lint, idx, n, layer0=True)
                _scatter(out["lw_norm"], lnorm, idx, n, layer0=True)
                bc["lw_emissivity"] = bc["lw_emissivity"].at[idx].set(
                    lbc["lw_emissivity"][:n])
                bc["lw_emission"] = bc["lw_emission"].at[idx].set(
                    lbc["lw_emission"][:n])

    out["bc_out"] = bc
    return out


def run_radsurf(config: Config, arrays: dict, mesh=None):
    """Run the surface radiation scheme on dense padded input arrays.

    Args:
      config: consolidated Config.
      arrays: dict of dense padded numpy arrays; see _gather_inputs for the
        expected keys, plus "i_representation" [C] and "nlay" [C].
      mesh: optional 1-D jax.sharding Mesh (parallel/mesh.py); when given,
        every group's column axis is padded to a device multiple and
        sharded over the mesh before the fused solve.

    Returns dict with "sw_norm_dir", "sw_norm_diff", "lw_internal",
    "lw_norm" flux containers and "bc_out" — all device-resident jnp
    arrays (gather with np.asarray only when writing output).
    Parity: radsurf() radsurf/radsurf_interface.F90:20-317.
    """
    rep = np.asarray(arrays["i_representation"])
    ncol = rep.shape[0]
    dz = arrays["dz"]
    nlay = dz.shape[1]
    dtype = jax.dtypes.canonicalize_dtype(
        dz.dtype if hasattr(dz, "dtype") else np.asarray(dz).dtype)
    ndev = int(mesh.devices.size) if mesh is not None else 1

    def padded(n):
        return -(-n // ndev) * ndev

    plan = []
    payloads = []

    # ---- flat tiles
    idx = np.nonzero(rep == TILE_FLAT)[0]
    if idx.size:
        n = int(idx.size)
        pl = {}
        if config.do_sw:
            galb = np.asarray(arrays["ground_albedo"])[idx]
            pl["galb"] = galb
            pl["galb_dir"] = (
                np.asarray(arrays["ground_albedo_dir"])[idx]
                if config.use_sw_direct_albedo else galb
            )
        if config.do_lw:
            pl["gemis"] = np.asarray(arrays["ground_emissivity"])[idx]
            pl["gemit"] = np.asarray(arrays["ground_emission"])[idx]
        pl = _pad_group(pl, n, padded(n))
        pl["idx"] = idx.astype(np.int32)
        plan.append(("flat", n))
        payloads.append(pl)

    # ---- layered SPARTACUS tiles
    for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        n = int(idx.size)
        pl = {"cos_sza": _take(arrays["cos_sza"], idx)}
        opt_sw = opt_lw = None
        if config.do_sw:
            pl["sw"] = _gather_inputs(arrays, idx, "sw",
                                      config.use_sw_direct_albedo)
            opt_sw = SolverOptions(**{**opt_kw, "nstream": lg_sw.nstream})
            from ..utils.debug import debug_arrays_enabled

            if debug_arrays_enabled():
                from .solver import debug_dump_sw

                debug_dump_sw(pl["sw"], opt_sw, lg_sw)
        if config.do_lw:
            pl["lw"] = _gather_inputs(arrays, idx, "lw")
            opt_lw = SolverOptions(**{**opt_kw, "nstream": lg_lw.nstream})
        pl = _pad_group(pl, n, padded(n))
        pl["idx"] = idx.astype(np.int32)
        plan.append(("spartacus", n, opt_sw, opt_lw, lg_sw, lg_lw))
        payloads.append(pl)

    # ---- simple urban / infinite street
    idx = np.nonzero(
        (rep == TILE_SIMPLE_URBAN) | (rep == TILE_INFINITE_STREET)
    )[0]
    if idx.size:
        if np.any(np.asarray(arrays["nlay"])[idx] != 1):
            raise ValueError(
                "simple urban representations must have only one layer"
            )
        n = int(idx.size)
        pl = {
            "is_inf": rep[idx] == TILE_INFINITE_STREET,
            "dz": np.asarray(arrays["dz"])[idx, 0],
            "bf": np.asarray(arrays["building_fraction"])[idx, 0],
            "bs": np.asarray(arrays["building_scale"])[idx, 0],
            "cos_sza": np.asarray(arrays["cos_sza"])[idx],
        }
        if config.do_sw:
            galb = np.asarray(arrays["ground_albedo"])[idx]
            pl["galb"] = galb
            pl["galb_dir"] = (
                np.asarray(arrays["ground_albedo_dir"])[idx]
                if config.use_sw_direct_albedo else galb
            )
            pl["ralb"] = np.asarray(arrays["roof_albedo"])[idx, 0]
            pl["walb"] = np.asarray(arrays["wall_albedo"])[idx, 0]
        if config.do_lw:
            pl["gemis"] = np.asarray(arrays["ground_emissivity"])[idx]
            pl["gemit"] = np.asarray(arrays["ground_emission"])[idx]
            pl["remis"] = np.asarray(arrays["roof_emissivity"])[idx, 0]
            pl["remit"] = np.asarray(arrays["roof_emission"])[idx, 0]
            pl["wemis"] = np.asarray(arrays["wall_emissivity"])[idx, 0]
            pl["wemit"] = np.asarray(arrays["wall_emission"])[idx, 0]
        pl = _pad_group(pl, n, padded(n))
        pl["idx"] = idx.astype(np.int32)
        plan.append(("simple", n, config.min_building_fraction))
        payloads.append(pl)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        col = NamedSharding(mesh, P("columns"))
        rep_sh = NamedSharding(mesh, P())

        def place(pl):
            out = {}
            for key, val in pl.items():
                if key == "idx":
                    out[key] = jax.device_put(val, rep_sh)
                else:
                    out[key] = jax.tree_util.tree_map(
                        lambda x: jax.device_put(np.asarray(x), col), val
                    )
            return out

        payloads = [place(pl) for pl in payloads]

    shape = (ncol, nlay,
             config.nswinternal if config.do_sw else 0,
             config.nlwinternal if config.do_lw else 0,
             bool(config.do_sw), bool(config.do_lw),
             bool(config.do_save_flux_profile), str(dtype))
    return _radsurf_core(tuple(payloads), tuple(plan), shape, mesh=mesh)
