"""Output writer: canopy fluxes -> NetCDF.

Parity: radsurf/radsurf_save.F90:26-693 — identical dimensions, variable
names, units, long names, fill value (-9999) and global attributes, with
broadband (spectral-summed), optional spectral and optional flux-profile
variables for SW and LW.  Dense padded layers are masked to the fill value
beyond each column's nlay.
"""

from __future__ import annotations

import numpy as np

from ..utils.netcdf_io import OutputFile

FILL = -9999.0

_SURFACE_TYPE_DEFN = (
    "0: Flat\n1: Forest\n2: Unvegetated urban\n3: Vegetated urban\n"
    "4: Simple urban\n5: Infinite street"
)


def _mask_layers(var, nlay):
    """Apply the fill value beyond each column's layer count, truncated to
    this file's layer dimension (= max(nlay), floored at 1).  The dense
    solver arrays keep the GLOBAL layer padding, which can exceed this
    file's deepest canopy when a multi-process column shard holds only
    shallow columns; the floor of 1 matches the file's layer dimension
    (a 0-size NetCDF3 dimension would become the unlimited record dim)."""
    nmaxlay = max(int(nlay.max()), 1)
    var = np.asarray(var)
    dt = var.dtype if var.dtype in (np.float32, np.float64) else np.float64
    out = np.array(var, dt)[:, :nmaxlay]
    mask = np.arange(nmaxlay)[None, :] >= nlay[:, None]
    out[mask] = FILL
    return out


def _flux_leaves(flux):
    """Flatten a flux container (nested dicts of arrays) to its arrays."""
    if isinstance(flux, dict):
        for v in flux.values():
            yield from _flux_leaves(v)
    elif flux is not None:
        yield flux


def save_canopy_fluxes(path, config, arrays, flux_sw, flux_lw, iverbose=None,
                       is_hdf5_file=False):
    """Write the output file (cf. save_canopy_fluxes,
    radsurf/radsurf_save.F90:26-166)."""
    nlay = arrays["nlay"]
    ncol = nlay.shape[0]
    # Floor of 1: a 0-size NetCDF3 dimension is the unlimited record dim
    # (all-flat multi-process shards have max(nlay) == 0); layered values
    # are then a single all-fill layer (cf. _mask_layers).
    nmaxlay = max(int(nlay.max()), 1)
    dz = arrays["dz"]

    with OutputFile(path, is_hdf5_file=is_hdf5_file) as out:
        out.define_dimension("column", ncol)
        out.define_dimension("layer", nmaxlay)
        out.define_dimension("layer_interface", nmaxlay + 1)
        do_spec_sw = config.do_sw and config.do_save_spectral_flux
        do_spec_lw = config.do_lw and config.do_save_spectral_flux
        do_bb_sw = config.do_sw and config.do_save_broadband_flux
        do_bb_lw = config.do_lw and config.do_save_broadband_flux
        if do_spec_sw:
            out.define_dimension("band_sw", config.nsw)
        if do_spec_lw:
            out.define_dimension("band_lw", config.nlw)

        out.put_global_attributes(
            title=(
                "Radiative fluxes from the SPARTACUS-Surface radiation model"
            ),
            references=(
                "Hogan, R. J., T. Quaife and R. Braghiere, 2018: Fast matrix"
                " treatment of 3-D radiative transfer in vegetation canopies:"
                " SPARTACUS-Vegetation 1.1. Geosci. Model Dev., 11, 339-350."
                "\nHogan, R. J., 2019: Flexible treatment of radiative"
                " transfer in complex urban canopies for use in weather and"
                " climate models. Boundary-Layer Meteorol., 173, 53-78."
            ),
            source="SPARTACUS-Surface offline radiation model (JAX build)",
            comment=(
                "All fluxes and absorption rates are in terms of power per"
                " unit horizontal area of the domain. Net fluxes are"
                " downwelling (or incoming) minus upwelling (or outgoing)."
            ),
        )

        out.define_variable(
            "height", ("column", "layer_interface"), units="m",
            long_name="Height of layer interfaces above ground",
            fill_value=-1.0, standard_name="height",
        )
        out.define_variable("surface_type", ("column",), dtype="h",
                            long_name="Surface type",
                            definition=_SURFACE_TYPE_DEFN)
        out.define_variable("nlayer", ("column",), dtype="h",
                            long_name="Number of active layers")

        height = np.full((ncol, nmaxlay + 1), -1.0)
        height[:, 0] = 0.0
        for jcol in range(ncol):
            n = nlay[jcol]
            height[jcol, 1 : n + 1] = np.cumsum(dz[jcol, :n])
        out.put("height", height)
        out.put("surface_type",
                np.asarray(arrays["i_representation"], np.int16))
        out.put("nlayer", np.asarray(nlay, np.int16))

        for band, long_band, flux, do_bb, do_spec in (
            ("sw", "shortwave", flux_sw, do_bb_sw, do_spec_sw),
            ("lw", "longwave", flux_lw, do_bb_lw, do_spec_lw),
        ):
            if flux is None:
                continue
            _define_and_write(out, band, long_band, flux, nlay, do_bb,
                              do_spec, config)


def _define_and_write(out, band, long_band, flux, nlay, do_bb, do_spec,
                      config):
    """Define + write one band's variables
    (radsurf_save.F90:168-418 and :421-627)."""
    # Variable presence follows the canopy_flux allocation logic
    # (radsurf_canopy_flux.F90:96-164): direct only for SW, urban/veg
    # blocks only when enabled in the configuration.
    use_direct = band == "sw"
    has_urban = config.do_urban
    has_veg = config.do_vegetation
    has_profiles = config.do_save_flux_profile
    coldim = ("column",)
    laydim = ("column", "layer")
    specdim = ("column", f"band_{band}")
    speclaydim = ("column", "layer", f"band_{band}")

    # Store flux fields in the WORKING precision: a single-precision
    # solve carries no information beyond f32, and f64 storage would
    # double the size and write time of production-scale outputs.
    flux_char = (
        "f"
        if any(np.asarray(v).dtype == np.float32
               for v in _flux_leaves(flux))
        else "d"
    )

    def dv(name, dims, **kw):
        out.define_variable(name, dims, units="W m-2",
                            dtype=kw.pop("dtype", flux_char), **kw)

    # Wavelength-independent variables
    if use_direct:
        out.define_variable("ground_sunlit_fraction", coldim, units="1",
                            long_name="Fraction of ground in direct sunlight")
        if has_urban:
            out.define_variable(
                "roof_sunlit_fraction", laydim, units="1", fill_value=FILL,
                long_name="Fraction of roof in direct sunlight")
            out.define_variable(
                "wall_sunlit_fraction", laydim, units="1", fill_value=FILL,
                long_name="Fraction of wall in direct sunlight")
        if has_veg:
            out.define_variable(
                "veg_sunlit_fraction", laydim, units="1", fill_value=FILL,
                long_name="Fraction of vegetation in direct sunlight")

    if do_bb:
        dv(f"ground_flux_dn_{band}", coldim,
           long_name=f"Downwelling {long_band} flux at ground")
        dv(f"ground_flux_net_{band}", coldim,
           long_name=f"Net {long_band} flux at ground")
        if use_direct:
            dv(f"ground_flux_dn_direct_{band}", coldim,
               long_name=f"Downwelling direct {long_band} flux at ground")
            dv(f"ground_flux_vertical_diffuse_{band}", coldim,
               long_name=(f"Diffuse {long_band} flux into a vertical surface"
                          " at ground level"))
        else:
            dv(f"ground_flux_vertical_{band}", coldim,
               long_name=(f"Flux in {long_band} into a vertical surface at"
                          " ground level"))
        dv(f"top_flux_dn_{band}", coldim,
           long_name=f"Downwelling {long_band} flux at top of canopy")
        dv(f"top_flux_net_{band}", coldim,
           long_name=f"Net {long_band} flux at top of canopy")
        if use_direct:
            dv(f"top_flux_dn_direct_{band}", coldim,
               long_name=(f"Downwelling direct {long_band} flux at top of"
                          " canopy"))
        if has_urban:
            dv(f"roof_flux_in_{band}", laydim, fill_value=FILL,
               long_name=f"Incoming {long_band} flux at roofs")
            if use_direct:
                dv(f"roof_flux_in_direct_{band}", laydim, fill_value=FILL,
                   long_name=f"Direct incoming {long_band} flux at roofs")
            dv(f"roof_flux_net_{band}", laydim, fill_value=FILL,
               long_name=f"Net {long_band} flux at roofs")
            dv(f"wall_flux_in_{band}", laydim, fill_value=FILL,
               long_name=f"Incoming {long_band} flux at walls")
            if use_direct:
                dv(f"wall_flux_in_direct_{band}", laydim, fill_value=FILL,
                   long_name=f"Direct incoming {long_band} flux at walls")
            dv(f"wall_flux_net_{band}", laydim, fill_value=FILL,
               long_name=f"Net {long_band} flux at walls")
        dv(f"clear_air_absorption_{band}", laydim, fill_value=FILL,
           long_name=f"Absorbed {long_band} in clear air")
        if has_veg:
            dv(f"veg_absorption_{band}", laydim, fill_value=FILL,
               long_name=f"Absorbed {long_band} by vegetation")
            dv(f"veg_air_absorption_{band}", laydim, fill_value=FILL,
               long_name=(f"Absorbed {long_band} by air in vegetated"
                          " regions"))
            if use_direct:
                dv(f"veg_absorption_direct_{band}", laydim, fill_value=FILL,
                   long_name=f"Absorbed direct {long_band} by vegetation")
        if has_profiles:
            dv(f"flux_dn_layer_top_{band}", laydim, fill_value=FILL,
               long_name=f"Downwelling {long_band} flux at top of layer")
            if use_direct:
                dv(f"flux_dn_direct_layer_top_{band}", laydim,
                   fill_value=FILL,
                   long_name=(f"Downwelling direct {long_band} flux at top"
                              " of layer"))
            dv(f"flux_up_layer_top_{band}", laydim, fill_value=FILL,
               long_name=f"Upwelling {long_band} flux at top of layer")
            dv(f"flux_dn_layer_base_{band}", laydim, fill_value=FILL,
               long_name=f"Downwelling {long_band} flux at base of layer")
            if use_direct:
                dv(f"flux_dn_direct_layer_base_{band}", laydim,
                   fill_value=FILL,
                   long_name=(f"Downwelling direct {long_band} flux at base"
                              " of layer"))
            dv(f"flux_up_layer_base_{band}", laydim, fill_value=FILL,
               long_name=f"Upwelling {long_band} flux at base of layer")

    if do_spec:
        dv(f"ground_spectral_flux_dn_{band}", specdim,
           long_name=f"Downwelling {long_band} spectral flux at ground")
        dv(f"ground_spectral_flux_net_{band}", specdim,
           long_name=f"Net {long_band} spectral flux at ground")
        if use_direct:
            dv(f"ground_spectral_flux_dn_direct_{band}", specdim,
               long_name=(f"Downwelling direct {long_band} spectral flux at"
                          " ground"))
            dv(f"ground_spectral_flux_vertical_diffuse_{band}", specdim,
               long_name=(f"Diffuse {long_band} spectral flux into a"
                          " vertical surface at ground level"))
        else:
            dv(f"ground_spectral_flux_vertical_{band}", specdim,
               long_name=(f"Flux in {long_band} into a vertical surface at"
                          " ground level"))
        dv(f"top_spectral_flux_dn_{band}", specdim,
           long_name=(f"Downwelling {long_band} spectral flux at top of"
                      " canopy"))
        dv(f"top_spectral_flux_net_{band}", specdim,
           long_name=f"Net {long_band} spectral flux at top of canopy")
        if use_direct:
            dv(f"top_spectral_flux_dn_direct_{band}", specdim,
               long_name=(f"Downwelling direct {long_band} spectral flux at"
                          " top of canopy"))
        if has_urban:
            dv(f"roof_spectral_flux_in_{band}", speclaydim, fill_value=FILL,
               long_name=f"Incoming {long_band} spectral flux at roofs")
            if use_direct:
                dv(f"roof_spectral_flux_in_direct_{band}", speclaydim,
                   fill_value=FILL,
                   long_name=(f"Direct incoming {long_band} spectral flux at"
                              " roofs"))
            dv(f"roof_spectral_flux_net_{band}", speclaydim, fill_value=FILL,
               long_name=f"Net {long_band} spectral flux at roofs")
            dv(f"wall_spectral_flux_in_{band}", speclaydim, fill_value=FILL,
               long_name=f"Incoming {long_band} spectral flux at walls")
            if use_direct:
                dv(f"wall_spectral_flux_in_direct_{band}", speclaydim,
                   fill_value=FILL,
                   long_name=(f"Direct incoming {long_band} spectral flux at"
                              " walls"))
            dv(f"wall_spectral_flux_net_{band}", speclaydim, fill_value=FILL,
               long_name=f"Net {long_band} spectral flux at walls")
        dv(f"clear_air_spectral_absorption_{band}", speclaydim,
           fill_value=FILL,
           long_name=f"Absorbed {long_band} in clear air")
        if has_veg:
            dv(f"veg_spectral_absorption_{band}", speclaydim, fill_value=FILL,
               long_name=f"Absorbed {long_band} by vegetation")
            dv(f"veg_air_spectral_absorption_{band}", speclaydim,
               fill_value=FILL,
               long_name=(f"Absorbed {long_band} by air in vegetated"
                          " regions"))
            if use_direct:
                dv(f"veg_spectral_absorption_direct_{band}", speclaydim,
                   fill_value=FILL,
                   long_name=f"Absorbed direct {long_band} by vegetation")
        if has_profiles:
            dv(f"spectral_flux_dn_layer_top_{band}", speclaydim,
               fill_value=FILL,
               long_name=(f"Downwelling {long_band} spectral flux at top of"
                          " layer"))
            if use_direct:
                dv(f"spectral_flux_dn_direct_layer_top_{band}", speclaydim,
                   fill_value=FILL,
                   long_name=(f"Downwelling direct {long_band} spectral flux"
                              " at top of layer"))
            dv(f"spectral_flux_up_layer_top_{band}", speclaydim,
               fill_value=FILL,
               long_name=(f"Upwelling {long_band} spectral flux at top of"
                          " layer"))
            dv(f"spectral_flux_dn_layer_base_{band}", speclaydim,
               fill_value=FILL,
               long_name=(f"Downwelling {long_band} spectral flux at base of"
                          " layer"))
            if use_direct:
                dv(f"spectral_flux_dn_direct_layer_base_{band}", speclaydim,
                   fill_value=FILL,
                   long_name=(f"Downwelling direct {long_band} spectral flux"
                              " at base of layer"))
            dv(f"spectral_flux_up_layer_base_{band}", speclaydim,
               fill_value=FILL,
               long_name=(f"Upwelling {long_band} spectral flux at base of"
                          " layer"))

    # ---- write values (radsurf_save.F90:421-627)
    def put_lay(name, var):
        out.put(name, _mask_layers(var, nlay))

    if use_direct:
        out.put("ground_sunlit_fraction", flux["ground_sunlit_frac"])
        if has_urban:
            put_lay("roof_sunlit_fraction", flux["roof_sunlit_frac"])
            put_lay("wall_sunlit_fraction", flux["wall_sunlit_frac"])
        if has_veg:
            put_lay("veg_sunlit_fraction", flux["veg_sunlit_frac"])

    if do_bb:
        bb = lambda v: np.asarray(v).sum(-1)
        out.put(f"ground_flux_dn_{band}", bb(flux["ground_dn"]))
        out.put(f"ground_flux_net_{band}", bb(flux["ground_net"]))
        if use_direct:
            out.put(f"ground_flux_dn_direct_{band}",
                    bb(flux["ground_dn_dir"]))
            out.put(f"ground_flux_vertical_diffuse_{band}",
                    bb(flux["ground_vertical_diff"]))
        else:
            out.put(f"ground_flux_vertical_{band}",
                    bb(flux["ground_vertical_diff"]))
        out.put(f"top_flux_dn_{band}", bb(flux["top_dn"]))
        out.put(f"top_flux_net_{band}", bb(flux["top_net"]))
        if use_direct:
            out.put(f"top_flux_dn_direct_{band}", bb(flux["top_dn_dir"]))
        if has_urban:
            put_lay(f"roof_flux_in_{band}", bb(flux["roof_in"]))
            put_lay(f"roof_flux_net_{band}", bb(flux["roof_net"]))
            put_lay(f"wall_flux_in_{band}", bb(flux["wall_in"]))
            put_lay(f"wall_flux_net_{band}", bb(flux["wall_net"]))
            if use_direct:
                put_lay(f"roof_flux_in_direct_{band}",
                        bb(flux["roof_in_dir"]))
                put_lay(f"wall_flux_in_direct_{band}",
                        bb(flux["wall_in_dir"]))
        put_lay(f"clear_air_absorption_{band}", bb(flux["clear_air_abs"]))
        if has_veg:
            put_lay(f"veg_absorption_{band}", bb(flux["veg_abs"]))
            put_lay(f"veg_air_absorption_{band}", bb(flux["veg_air_abs"]))
            if use_direct:
                put_lay(f"veg_absorption_direct_{band}",
                        bb(flux["veg_abs_dir"]))
        if has_profiles:
            put_lay(f"flux_dn_layer_top_{band}",
                    bb(flux["flux_dn_layer_top"]))
            put_lay(f"flux_up_layer_top_{band}",
                    bb(flux["flux_up_layer_top"]))
            put_lay(f"flux_dn_layer_base_{band}",
                    bb(flux["flux_dn_layer_base"]))
            put_lay(f"flux_up_layer_base_{band}",
                    bb(flux["flux_up_layer_base"]))
            if use_direct:
                put_lay(f"flux_dn_direct_layer_top_{band}",
                        bb(flux["flux_dn_dir_layer_top"]))
                put_lay(f"flux_dn_direct_layer_base_{band}",
                        bb(flux["flux_dn_dir_layer_base"]))

    if do_spec:
        def put_spec_lay(name, var):
            v = np.array(var, np.float64)
            mask = np.arange(v.shape[1])[None, :, None] >= nlay[:, None, None]
            v = np.where(mask, FILL, v)
            out.put(name, v)

        out.put(f"ground_spectral_flux_dn_{band}", flux["ground_dn"])
        out.put(f"ground_spectral_flux_net_{band}", flux["ground_net"])
        if use_direct:
            out.put(f"ground_spectral_flux_dn_direct_{band}",
                    flux["ground_dn_dir"])
            out.put(f"ground_spectral_flux_vertical_diffuse_{band}",
                    flux["ground_vertical_diff"])
        else:
            out.put(f"ground_spectral_flux_vertical_{band}",
                    flux["ground_vertical_diff"])
        out.put(f"top_spectral_flux_dn_{band}", flux["top_dn"])
        out.put(f"top_spectral_flux_net_{band}", flux["top_net"])
        if use_direct:
            out.put(f"top_spectral_flux_dn_direct_{band}",
                    flux["top_dn_dir"])
        if has_urban:
            put_spec_lay(f"roof_spectral_flux_in_{band}", flux["roof_in"])
            put_spec_lay(f"roof_spectral_flux_net_{band}", flux["roof_net"])
            put_spec_lay(f"wall_spectral_flux_in_{band}", flux["wall_in"])
            put_spec_lay(f"wall_spectral_flux_net_{band}", flux["wall_net"])
            if use_direct:
                put_spec_lay(f"roof_spectral_flux_in_direct_{band}",
                             flux["roof_in_dir"])
                put_spec_lay(f"wall_spectral_flux_in_direct_{band}",
                             flux["wall_in_dir"])
        put_spec_lay(f"clear_air_spectral_absorption_{band}",
                     flux["clear_air_abs"])
        if has_veg:
            put_spec_lay(f"veg_spectral_absorption_{band}", flux["veg_abs"])
            put_spec_lay(f"veg_air_spectral_absorption_{band}",
                         flux["veg_air_abs"])
            if use_direct:
                put_spec_lay(f"veg_spectral_absorption_direct_{band}",
                             flux["veg_abs_dir"])
        if has_profiles:
            put_spec_lay(f"spectral_flux_dn_layer_top_{band}",
                         flux["flux_dn_layer_top"])
            put_spec_lay(f"spectral_flux_up_layer_top_{band}",
                         flux["flux_up_layer_top"])
            put_spec_lay(f"spectral_flux_dn_layer_base_{band}",
                         flux["flux_dn_layer_base"])
            put_spec_lay(f"spectral_flux_up_layer_base_{band}",
                         flux["flux_up_layer_base"])
            if use_direct:
                put_spec_lay(f"spectral_flux_dn_direct_layer_top_{band}",
                             flux["flux_dn_dir_layer_top"])
                put_spec_lay(f"spectral_flux_dn_direct_layer_base_{band}",
                             flux["flux_dn_dir_layer_base"])
