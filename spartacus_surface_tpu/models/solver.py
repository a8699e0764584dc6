"""The unified SPARTACUS multi-layer solver (forest + urban, SW + LW).

One solver covers all layered tile types: a forest is an urban canopy with
building_fraction == 0 (the urban region fractions, perimeters and overlap
matrices reduce exactly to the forest ones in that limit — the property
exercised by the reference's consistency test, test/simple/README:8-11).

Structure (matching the three-phase shape of the reference solvers,
radsurf/radsurf_urban_sw.F90 / radsurf_urban_lw.F90 / radsurf_forest_sw.F90 /
radsurf_forest_lw.F90):

  phase 1  per-layer operators:   ONE huge batched call over
           [ncol, nlay, nspec] to ops.layer_matrices — this is the hot
           kernel and replaces the reference's per-layer eigen factory loop
           (radsurf_urban_sw.F90:335-585).
  phase 2  upward adding scan:    lax.scan over layers computing interface
           albedo/source operators (radsurf_urban_sw.F90:604-654,
           radsurf_urban_lw.F90:567-614).
  phase 3  downward flux scans:   lax.scan (reverse) computing the
           normalized flux profiles, absorption integrals and sunlit
           fractions (radsurf_urban_sw.F90:676-1001,
           radsurf_urban_lw.F90:639-858).

Ragged columns are dense-padded ABOVE the real canopy with dz = 0 layers
(zero fractions/extinctions): expm(Gamma*0) = I makes every padding layer an
exact no-op, and the free-atmosphere fractions [1, 0, ...] of padding layers
reproduce the reference's top-of-canopy overlap at the real canopy top
(radsurf_overlap.F90:341-346).

The cosine of the solar zenith angle is clamped to >= 1e-6 throughout, as in
the urban reference path (radsurf_urban_sw.F90:268); callers skip the SW
solve entirely when the sun is below the horizon
(radsurf_interface.F90:183,217,248).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layer_matrices import layer_matrices, lw_layer_matrices
from ..ops.legendre_gauss import LegendreGauss
from ..ops.matrix import matmul, matvec, solve
from ..utils import memory
from ..utils.constants import Pi
from . import gamma as G
from .geometry import (
    norm_perim_urban,
    od_scaling_from_fsd,
    overlap_matrices_urban,
    region_fracs,
)


# ----------------------------------------------------------------------
# Expanded-overlap products (the reference's rect_expandedmat_* family,
# radtool/radtool_matrix.F90:505-651): overlap matrices act on the region
# index of vectors/matrices whose combined index is (region, stream).
# ----------------------------------------------------------------------

def _safe_div(num, den):
    """num / den with 0 where the denominator has underflowed to ~0.

    Used for the clear-sky-normalized sunlit fractions: at horizon sun
    through a thick canopy the clear direct beam extinguishes completely
    (exp(-od) underflows), and the reference's unguarded division would
    FPE-trap (-ffpe-trap=invalid, Makefile_include.gfortran:14); here the
    physically-correct limit is "nothing is sunlit" = 0."""
    tiny = jnp.asarray(np.finfo(jnp.result_type(den)).tiny, den.dtype)
    ok = den > tiny
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)


def _ov_vec(ov, x, ns):
    """[C, A, B] region-overlap applied to [C, S, B*ns] -> [C, S, A*ns]."""
    c, s, _ = x.shape
    b = ov.shape[-1]
    xr = x.reshape(c, s, b, ns)
    out = jnp.einsum("cab,csbn->csan", ov, xr, precision="highest")
    return out.reshape(c, s, ov.shape[-2] * ns)


def _ov_dirvec(ov, x):
    """[C, A, B] applied to direct vector [C, S, B] -> [C, S, A]."""
    return jnp.einsum("cab,csb->csa", ov, x, precision="highest")


def _u_mat_v(u, m, v, ns):
    """a_above' = (u (x) I_ns) @ m @ (v (x) I_ns).

    u: [C, A, B]; m: [C, S, B*ns, B2*ns]; v: [C, B2, A2] -> [C, S, A*ns, A2*ns]
    (parity: radsurf_urban_sw.F90:646-649).
    """
    c, s = m.shape[:2]
    b = u.shape[-1]
    b2 = v.shape[-2]
    mr = m.reshape(c, s, b, ns, b2, ns)
    out = jnp.einsum("ctq,csqurv,crf->cstufv", u, mr, v, precision="highest")
    a, a2 = u.shape[-2], v.shape[-1]
    return out.reshape(c, s, a * ns, a2 * ns)


def _u_dmat_v(u, d, v, ns):
    """d_above' = (u (x) I_ns) @ d @ v.

    u: [C, A, B]; d: [C, S, B*ns, B2]; v: [C, B2, A2] -> [C, S, A*ns, A2]
    (parity: radsurf_urban_sw.F90:650-653).
    """
    c, s = d.shape[:2]
    b = u.shape[-1]
    dr = d.reshape(c, s, b, ns, d.shape[-1])
    out = jnp.einsum("ctq,csqur,crf->cstuf", u, dr, v, precision="highest")
    return out.reshape(c, s, u.shape[-2] * ns, v.shape[-1])


def _u_vec(u, x, ns):
    """source_above' = (u (x) I_ns) @ x;  u: [C, A, B], x: [C, S, B*ns]."""
    return _ov_vec(u, x, ns)


# ----------------------------------------------------------------------
# Inputs container (a pytree of dense padded arrays for one column group)
# ----------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class CanopyInputs:
    """Dense padded inputs for a group of columns sharing one solver config.

    Shapes: [C] per-column, [C, L] per-layer (L = padded layer count,
    bottom-up, padding above the canopy with dz=0 and zero fractions),
    [C, S] per-column-spectral, [C, L, S] per-layer-spectral.
    """

    dz: jnp.ndarray  # [C, L]
    cos_sza: jnp.ndarray  # [C]
    veg_fraction: jnp.ndarray  # [C, L]
    veg_scale: jnp.ndarray  # [C, L]
    veg_ext: jnp.ndarray  # [C, L]
    veg_fsd: jnp.ndarray  # [C, L]
    veg_contact_fraction: jnp.ndarray  # [C, L]
    building_fraction: jnp.ndarray  # [C, L]
    building_scale: jnp.ndarray  # [C, L]
    air_ext: jnp.ndarray  # [C, L, S]
    air_ssa: jnp.ndarray  # [C, L, S]
    veg_ssa: jnp.ndarray  # [C, L, S]
    # SW facet properties (None for LW)
    ground_albedo: jnp.ndarray | None = None  # [C, S]
    ground_albedo_dir: jnp.ndarray | None = None  # [C, S]
    roof_albedo: jnp.ndarray | None = None  # [C, L, S]
    roof_albedo_dir: jnp.ndarray | None = None  # [C, L, S]
    wall_albedo: jnp.ndarray | None = None  # [C, L, S]
    wall_specular_frac: jnp.ndarray | None = None  # [C, L, S]
    # LW facet/volume properties (None for SW)
    ground_emissivity: jnp.ndarray | None = None  # [C, S]
    ground_emission: jnp.ndarray | None = None  # [C, S]
    roof_emissivity: jnp.ndarray | None = None  # [C, L, S]
    roof_emission: jnp.ndarray | None = None  # [C, L, S]
    wall_emissivity: jnp.ndarray | None = None  # [C, L, S]
    wall_emission: jnp.ndarray | None = None  # [C, L, S]
    clear_air_planck: jnp.ndarray | None = None  # [C, L, S]
    veg_planck: jnp.ndarray | None = None  # [C, L, S]
    veg_air_planck: jnp.ndarray | None = None  # [C, L, S]


@dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration for one column group."""

    nreg: int
    nstream: int
    do_urban: bool  # include wall/roof physics and outputs
    use_symmetric_vegetation_scale: bool = True
    vegetation_isolation_factor: float = 0.0
    min_vegetation_fraction: float = 1.0e-6
    min_building_fraction: float = 1.0e-6
    # Doubling-step CAP for the norm-adaptive expm factory: handles
    # per-layer ||Gamma dz|| up to theta*2**n_double.  30 covers the most
    # extreme attainable system — horizon sun (cos_sza clamped at 1e-6)
    # injects tan(theta) ~ 1e6 wall/direct terms, and ext*dz ~ 1e3 —
    # whose norm is ~1e9; a smaller cap silently truncates the Pade
    # argument and the layer operators come out wrong (found by the
    # property fuzzer: top_albedo 5.5e4 at cap 12).  Adaptive K means
    # typical layers still take only their ceil(log2(norm/2)) steps.
    n_double: int = 30
    # Replace the sequential lax.scan adding/flux recurrences with
    # O(log nlay)-depth associative scans (ops/assoc_adding.py): the
    # upward interface-operator build becomes a Redheffer-star prefix
    # composition, the downward flux recurrence a suffix composition of
    # block-affine carry maps.  ~4-6x more FLOPs but L/log2(L) less
    # dependency depth — for very deep canopies (hundreds of layers) at
    # small batch, where the layer chain rather than throughput binds.
    # Parity with the scan path is exercised in tests/test_associative.py.
    associative_sweeps: bool = False
    # Solve in column chunks of this size via lax.map (0 = whole batch in
    # one pass; -1 = AUTO, see _resolve_column_chunk).  Bounds the device
    # working set: every column x layer x band element carries its own
    # factory matrices and interface-operator stacks, so the footprint
    # grows linearly with the batch (utils/memory.py).  Columns are padded
    # up to a chunk multiple with no-op values and sliced off.  Under a
    # mesh, run_radsurf executes the solver inside jax.shard_map, so the
    # chunk reshape (and AUTO resolution) sees the per-device LOCAL batch.
    column_chunk: int = 0


# ----------------------------------------------------------------------
# Shared geometry preparation
# ----------------------------------------------------------------------

def _prepare_geometry(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                      lw: bool):
    nreg = opt.nreg
    # building_fraction is pre-sanitized to zeros for forest solves by
    # _sanitize_forest (public entry points) — see that helper's docstring.
    frac = region_fracs(inp.veg_fraction, inp.building_fraction, nreg)
    od_scal = od_scaling_from_fsd(inp.veg_fsd, nreg)
    u_ov, v_ov = overlap_matrices_urban(frac, nreg, opt.min_vegetation_fraction)
    norm_perim, norm_perim_wall = norm_perim_urban(
        inp.building_fraction,
        inp.building_scale,
        inp.veg_fraction,
        inp.veg_scale,
        inp.veg_contact_fraction,
        nreg=nreg,
        use_symmetric_vegetation_scale=opt.use_symmetric_vegetation_scale,
        vegetation_isolation_factor=opt.vegetation_isolation_factor,
        min_vegetation_fraction=opt.min_vegetation_fraction,
        min_building_fraction=opt.min_building_fraction,
    )
    f_exchange = G.exchange_rates(
        norm_perim, frac, nreg, opt.min_vegetation_fraction
    )
    adjustment = lg.vadjustment2 if lw else 1.0
    f_wall = G.wall_rates(
        norm_perim_wall, frac, nreg, opt.min_vegetation_fraction, adjustment
    )
    if not opt.do_urban:
        f_wall = jnp.zeros_like(f_wall)
    return dict(
        frac=frac,
        od_scaling=od_scal,
        u_ov=u_ov,
        v_ov=v_ov,
        norm_perim_wall=norm_perim_wall,
        f_exchange=f_exchange,
        f_wall=f_wall,
    )


def debug_dump_sw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss):
    """PRINT_ARRAYS equivalent: print the geometry and Gamma matrices for
    the first column/band (cf. radsurf_forest_sw.F90:389-403)."""
    from ..utils.debug import maybe_dump

    zcos = jnp.maximum(inp.cos_sza, 1.0e-6)
    sin0 = jnp.sqrt(1.0 - zcos * zcos)
    geo = _prepare_geometry(inp, opt, lg, lw=False)
    ext_reg, ssa_reg = G.region_optics_sw(
        inp.air_ext, inp.air_ssa, inp.veg_ext, inp.veg_ssa,
        geo["od_scaling"], opt.nreg,
    )
    wall_ext = (
        1.0 - inp.wall_albedo * inp.wall_specular_frac
        if opt.do_urban else jnp.zeros_like(inp.air_ext)
    )
    wall_factor = (
        inp.wall_albedo * (1.0 - inp.wall_specular_frac)
        if opt.do_urban else jnp.zeros_like(inp.air_ext)
    )
    g0, g1, g2, g3 = G.assemble_gammas(
        ext_reg, ssa_reg, geo["f_exchange"], geo["f_wall"],
        wall_ext, wall_factor, lg, opt.nreg,
        cos_sza=zcos, sin_sza=sin0, tan_sza=sin0 / zcos,
    )
    maybe_dump("SW first column, layer 0, band 0", {
        "frac": geo["frac"][0, 0],
        "od_scaling": geo["od_scaling"][0, 0],
        "f_exchange": geo["f_exchange"][0, 0],
        "f_wall": geo["f_wall"][0, 0],
        "norm_perim_wall": geo["norm_perim_wall"][0, 0],
        "u_overlap": geo["u_ov"][0, 0],
        "v_overlap": geo["v_ov"][0, 0],
        "ext_reg": ext_reg[0, 0, 0],
        "ssa_reg": ssa_reg[0, 0, 0],
        "gamma0": g0[0, 0, 0],
        "gamma1": g1[0, 0, 0],
        "gamma2": g2[0, 0, 0],
        "gamma3": g3[0, 0, 0],
    })


def _itransp(air_ext, dz):
    """Most transparent spectral interval per column
    (radsurf_urban_sw.F90:310)."""
    total_od = jnp.sum(air_ext * dz[..., None], axis=1)  # [C, S]
    return jnp.argmin(total_od, axis=-1)  # [C]


def _take_spec(x, itr):
    """Gather the itransp spectral slice: [C, ..., S] -> [C, ...]."""
    itr_b = itr.reshape(itr.shape + (1,) * (x.ndim - 1))
    return jnp.take_along_axis(x, itr_b, axis=-1)[..., 0]


# ----------------------------------------------------------------------
# Shortwave solver
# ----------------------------------------------------------------------

def _spartacus_sw_impl(inp: CanopyInputs, opt: SolverOptions,
                       lg: LegendreGauss, with_profiles: bool = False):
    """Shortwave solve for one column group.

    Returns (norm_dir, norm_diff, bc) where norm_dir/norm_diff are flux dicts
    normalized by the top-of-canopy direct / diffuse downwelling flux
    respectively, and bc = {"top_albedo_diff", "top_albedo_dir"} [C, S].
    Parity: radsurf/radsurf_urban_sw.F90:35-1007 (forest =
    radsurf_forest_sw.F90 via building_fraction = 0).
    """
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype = inp.air_ext.dtype
    mu = np.asarray(lg.mu, dtype)
    hw = np.asarray(lg.hweight, dtype)
    tan_s = np.asarray(lg.tan_ang, dtype)

    zcos = jnp.maximum(inp.cos_sza, 1.0e-6)
    sin0 = jnp.sqrt(1.0 - zcos * zcos)
    tan0 = sin0 / zcos

    geo = _prepare_geometry(inp, opt, lg, lw=False)
    frac = geo["frac"]

    # Wall extinction/scattering factors (radsurf_urban_sw.F90:412-418)
    if opt.do_urban:
        wall_ext = 1.0 - inp.wall_albedo * inp.wall_specular_frac
        wall_factor = inp.wall_albedo * (1.0 - inp.wall_specular_frac)
        wall_albedo = inp.wall_albedo
    else:
        wall_ext = jnp.zeros((C, L, S), dtype)
        wall_factor = jnp.zeros((C, L, S), dtype)
        wall_albedo = jnp.zeros((C, L, S), dtype)

    ext_reg, ssa_reg = G.region_optics_sw(
        inp.air_ext, inp.air_ssa, inp.veg_ext, inp.veg_ssa,
        geo["od_scaling"], nreg,
    )
    g0, g1, g2, g3 = G.assemble_gammas(
        ext_reg, ssa_reg, geo["f_exchange"], geo["f_wall"],
        wall_ext, wall_factor, lg, nreg,
        cos_sza=zcos, sin_sza=sin0, tan_sza=tan0,
    )
    dz_b = jnp.broadcast_to(inp.dz[:, :, None], (C, L, S))
    g0 = jnp.broadcast_to(g0, (C, L, S, nreg, nreg))
    lay = layer_matrices(g0, g1, g2, g3, dz_b, n_double=opt.n_double)

    # ------------------------------------------------------------------
    # Phase 2: upward adding scan (radsurf_urban_sw.F90:590-654)
    # ------------------------------------------------------------------
    galb = inp.ground_albedo  # [C, S]
    galb_dir = inp.ground_albedo_dir
    # Ground albedo operators: same-region coupling only
    # (radsurf_urban_sw.F90:593-602)
    block = np.zeros((nreg, ns, nreg, ns))
    for r in range(nreg):
        block[r, :, r, :] = 1.0
    same_reg = jnp.asarray(
        (block * hw[None, :, None, None]).reshape(nd, nd), dtype
    )
    a_ground = galb[:, :, None, None] * same_reg  # [C, S, nd, nd]
    dblock = np.zeros((nreg, ns, nreg))
    for r in range(nreg):
        dblock[r, :, r] = hw
    dmask = jnp.asarray(dblock.reshape(nd, nreg), dtype)
    d_ground = (zcos[:, None] * galb_dir)[:, :, None, None] * dmask

    roof_alb = inp.roof_albedo if opt.do_urban else jnp.zeros((C, L, S), dtype)
    roof_alb_dir = (
        inp.roof_albedo_dir if opt.do_urban else jnp.zeros((C, L, S), dtype)
    )

    def up_step(carry, x):
        a_above, d_above = carry
        R, T, E, Sup, Sdn, u_ov, v_ov, ralb, ralb_dir = x
        eye = jnp.eye(nd, dtype=dtype)
        denom = eye - matmul(a_above, R)
        # a_below/d_below for the permeable regions
        # (radsurf_urban_sw.F90:607-625)
        at = solve(denom, matmul(a_above, T))
        a_below_reg = R + matmul(T, at)
        d_rhs = matmul(d_above, E) + matmul(a_above, Sdn)
        d_below_reg = Sup + matmul(T, solve(denom, d_rhs))
        # Exposed-roof rows (radsurf_urban_sw.F90:627-643): build the full
        # (nreg+1)*ns square/rect operators
        a_roof = (ralb[:, :, None, None] * hw[:, None]) * jnp.ones(
            (ns, ns), dtype
        )  # [C, S, ns, ns]
        d_roof = (zcos[:, None] * ralb_dir)[:, :, None] * hw  # [C, S, ns]
        a_below = jnp.zeros((C, S, (nreg + 1) * ns, (nreg + 1) * ns), dtype)
        a_below = a_below.at[..., :nd, :nd].set(a_below_reg)
        a_below = a_below.at[..., nd:, nd:].set(a_roof)
        d_below = jnp.zeros((C, S, (nreg + 1) * ns, nreg + 1), dtype)
        d_below = d_below.at[..., :nd, :nreg].set(d_below_reg)
        d_below = d_below.at[..., nd:, nreg].set(d_roof)
        # Overlap to just above the interface (radsurf_urban_sw.F90:646-653)
        a_above_new = _u_mat_v(u_ov, a_below, v_ov, ns)
        d_above_new = _u_dmat_v(u_ov, d_below, v_ov, ns)
        ys = (a_above, d_above, denom, a_below, d_below)
        return (a_above_new, d_above_new), ys

    xs = (
        lay["R"].swapaxes(0, 1),
        lay["T"].swapaxes(0, 1),
        lay["E"].swapaxes(0, 1),
        lay["Sup"].swapaxes(0, 1),
        lay["Sdn"].swapaxes(0, 1),
        geo["u_ov"].swapaxes(0, 1),
        geo["v_ov"].swapaxes(0, 1),
        roof_alb.transpose(1, 0, 2),
        roof_alb_dir.transpose(1, 0, 2),
    )
    if opt.associative_sweeps:
        # Log-depth route: all per-layer carry-ins at once via the
        # Redheffer-star prefix composition, then ONE vmapped up_step
        # recovers the per-layer ys (identical local algebra, no chain).
        from ..ops.assoc_adding import (
            ground_star_element,
            star_prefix,
            sw_layer_star_elements,
        )

        elems = sw_layer_star_elements(
            xs[0], xs[1],
            xs[2], xs[3],
            xs[4], xs[5], xs[6],
            xs[7][..., None, None] * (hw[:, None] * jnp.ones((ns, ns), dtype)),
            (zcos[None, :, None] * xs[8])[..., None] * jnp.asarray(hw, dtype),
            nreg, ns,
        )
        prefix = star_prefix(
            elems, ground_star_element(a_ground, d_ground, nreg)
        )
        a_top, d_top = prefix["Rd"][-1], prefix["Su"][-1]
        _, ys = jax.vmap(up_step)((prefix["Rd"][:-1], prefix["Su"][:-1]), xs)
    else:
        (a_top, d_top), ys = jax.lax.scan(up_step, (a_ground, d_ground), xs)
    a_above_l, d_above_l, denom_l, a_below_l, d_below_l = ys

    # Top-of-canopy boundary conditions (radsurf_urban_sw.F90:668-674)
    hw_b = jnp.asarray(hw, dtype)
    top_albedo_diff = jnp.einsum(
        "csij,j->cs", a_top[..., :ns, :ns], hw_b, precision="highest"
    )
    top_albedo_dir = jnp.sum(d_top[..., :ns, 0], axis=-1) / zcos[:, None]
    bc = {"top_albedo_diff": top_albedo_diff, "top_albedo_dir": top_albedo_dir}

    # ------------------------------------------------------------------
    # Phase 3: downward flux sweeps (radsurf_urban_sw.F90:676-1001)
    # ------------------------------------------------------------------
    air_abs_coef = inp.air_ext * (1.0 - inp.air_ssa)  # [C, L, S]
    veg_abs_coef = inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)  # [C, L, S]
    itr = _itransp(inp.air_ext, inp.dz)
    air_ext_t = jnp.take_along_axis(inp.air_ext, itr[:, None, None], axis=-1)[..., 0]

    # Roof/non-building fractions (radsurf_urban_sw.F90:292-298);
    # building_fraction is zeros for forest (_sanitize_forest)
    bf_above = jnp.concatenate(
        [inp.building_fraction[:, 1:], jnp.zeros((C, 1), dtype)], axis=1
    )
    roof_fraction = jnp.maximum(0.0, inp.building_fraction - bf_above)
    nbf = 1.0 - inp.building_fraction  # [C, L]
    nbf_above = 1.0 - bf_above

    # Clear-sky direct transmittance per layer at itransp
    # (radsurf_urban_sw.F90:817)
    trans_dir_clear = jnp.exp(-air_ext_t * inp.dz / zcos[:, None])  # [C, L]

    # f_wall treating all non-building regions as clear
    # (radsurf_urban_sw.F90:405-410)
    npw_sum = jnp.sum(geo["norm_perim_wall"], axis=-1)
    f_wall_dir_clear = jnp.where(
        nbf > opt.min_building_fraction,
        npw_sum / (Pi * jnp.maximum(nbf, opt.min_building_fraction)),
        0.0,
    )

    def sweep(with_direct: bool):
        eps = jnp.finfo(dtype).eps

        def down_step(carry, x):
            dn_dir, dn_diff, dn_dir_clear = carry
            (R, T, E, Sdn, int_dir, int_diff, int_dir_diff, a_above,
             d_above, denom, a_below, d_below, u_ov, v_ov, fw, fwdc,
             od_l, ab_coef, vb_coef, wa, dz_l, aet, rfrac, nbf_l, nbfa, tdc,
             vfr) = x
            # Translate across the interface at layer top
            # (radsurf_urban_sw.F90:707-714)
            dn_dir_below = _ov_dirvec(v_ov, dn_dir)  # [C, S, nreg+1]
            dn_diff_below = _ov_vec(v_ov, dn_diff, ns)  # [C, S, (nreg+1)ns]
            up_below = matvec(a_below, dn_diff_below)
            if with_direct:
                up_below = up_below + matvec(d_below, dn_dir_below)
            out = {}
            # Roof fluxes (radsurf_urban_sw.F90:716-721)
            roof_in_dir = zcos[:, None] * dn_dir_below[..., nreg]
            roof_in = jnp.sum(dn_diff_below[..., nd:], axis=-1)
            roof_up = jnp.sum(up_below[..., nd:], axis=-1)
            if with_direct:
                roof_in = roof_in + roof_in_dir
            out["roof_in"] = roof_in
            out["roof_net"] = roof_in - roof_up
            if with_direct:
                out["roof_in_dir"] = roof_in_dir
            # Fluxes at layer base (radsurf_urban_sw.F90:723-735)
            if with_direct:
                dn_dir_new = matvec(E, dn_dir_below[..., :nreg])
                refl_dir = matvec(d_above, dn_dir_new)
                rhs = (
                    matvec(T, dn_diff_below[..., :nd])
                    + matvec(R, refl_dir)
                    + matvec(Sdn, dn_dir_below[..., :nreg])
                )
                dn_diff_new = solve(denom, rhs)
                up_above = matvec(a_above, dn_diff_new) + refl_dir
            else:
                dn_dir_new = dn_dir
                dn_diff_new = solve(denom, matvec(T, dn_diff_below[..., :nd]))
                up_above = matvec(a_above, dn_diff_new)
            # Flux profiles (radsurf_urban_sw.F90:737-751)
            if with_profiles:
                out["flux_dn_layer_top"] = jnp.sum(
                    dn_diff_below[..., :nd], axis=-1
                )
                out["flux_up_layer_top"] = jnp.sum(up_below[..., :nd], axis=-1)
                out["flux_dn_layer_base"] = jnp.sum(dn_diff_new, axis=-1)
                out["flux_up_layer_base"] = jnp.sum(up_above, axis=-1)
                if with_direct:
                    out["flux_dn_dir_layer_top"] = zcos[:, None] * jnp.sum(
                        dn_dir_below[..., :nreg], axis=-1
                    )
                    out["flux_dn_dir_layer_base"] = zcos[:, None] * jnp.sum(
                        dn_dir_new, axis=-1
                    )
                    out["flux_dn_layer_top"] = (
                        out["flux_dn_layer_top"] + out["flux_dn_dir_layer_top"]
                    )
                    out["flux_dn_layer_base"] = (
                        out["flux_dn_layer_base"]
                        + out["flux_dn_dir_layer_base"]
                    )
            # Integrated fluxes (radsurf_urban_sw.F90:753-761)
            conv_diff = (
                dn_diff_below[..., :nd] - dn_diff_new
                - up_below[..., :nd] + up_above
            )
            int_flux_diff = matvec(int_diff, conv_diff)
            if with_direct:
                conv_dir = dn_dir_below[..., :nreg] - dn_dir_new
                int_flux_dir = matvec(int_dir, conv_dir)
                int_flux_diff = int_flux_diff + matvec(int_dir_diff, conv_dir)
            else:
                int_flux_dir = jnp.zeros((C, S, nreg), dtype)
            # Absorption (radsurf_urban_sw.F90:763-788)
            ifd = int_flux_diff.reshape(C, S, nreg, ns)
            ifd_mu = jnp.einsum("csrn,n->csr", ifd, 1.0 / mu,
                                precision="highest")
            out["clear_air_abs"] = ab_coef * (
                int_flux_dir[..., 0] + ifd_mu[..., 0]
            )
            if nreg > 1:
                veg_sum = jnp.sum(
                    (int_flux_dir[..., 1:] + ifd_mu[..., 1:]) * od_l[:, None, :],
                    axis=-1,
                )
                out["veg_air_abs"] = ab_coef * jnp.sum(
                    int_flux_dir[..., 1:] + ifd_mu[..., 1:], axis=-1
                )
                out["veg_abs"] = vb_coef * veg_sum
                if with_direct:
                    out["veg_abs_dir"] = vb_coef * jnp.sum(
                        int_flux_dir[..., 1:] * od_l[:, None, :], axis=-1
                    )
            # Wall fluxes (radsurf_urban_sw.F90:790-802, 955-963)
            if opt.do_urban:
                ifd_tan = jnp.einsum("csrn,n->csr", ifd, tan_s,
                                     precision="highest")
                wall_in = jnp.einsum("cr,csr->cs", fw, ifd_tan,
                                     precision="highest")
                if with_direct:
                    wall_in_dir = sin0[:, None] * jnp.einsum(
                        "cr,csr->cs", fw, int_flux_dir, precision="highest"
                    )
                    out["wall_in_dir"] = wall_in_dir
                    wall_in = wall_in + wall_in_dir
                out["wall_in"] = wall_in
                out["wall_net"] = wall_in * (1.0 - wa)
            # Sunlit fractions (radsurf_urban_sw.F90:804-848)
            if with_direct:
                roof_in_dir_t = jnp.take_along_axis(
                    roof_in_dir, itr[:, None], axis=-1
                )[..., 0]
                out["roof_sunlit_frac"] = _safe_div(
                    roof_in_dir_t * nbfa,
                    zcos * dn_dir_clear
                    * jnp.maximum(opt.min_building_fraction, rfrac),
                )
                dn_dir_clear = dn_dir_clear * nbf_l / nbfa
                int_dir_clear = jnp.where(
                    aet > 0.0,
                    dn_dir_clear * (1.0 - tdc) * zcos / jnp.where(
                        aet > 0.0, aet, 1.0),
                    dn_dir_clear * dz_l,
                )
                if nreg > 1:
                    vb_t = jnp.take_along_axis(
                        vb_coef, itr[:, None], axis=-1
                    )[..., 0]
                    veg_abs_dir_clear = int_dir_clear * vb_t * vfr
                    vad_t = jnp.take_along_axis(
                        out["veg_abs_dir"], itr[:, None], axis=-1
                    )[..., 0]
                    # Degenerate-region excision parity: below the
                    # min fraction the reference removes the veg region
                    # from the system entirely, so nothing is absorbed in
                    # it and its sunlit fraction is exactly 0
                    # (radsurf_urban_sw.F90 region handling); the masked
                    # dense path would otherwise return tiny/tiny ~ 1.
                    out["veg_sunlit_frac"] = jnp.where(
                        vfr >= opt.min_vegetation_fraction,
                        vad_t / jnp.maximum(eps, veg_abs_dir_clear),
                        0.0,
                    )
                if opt.do_urban:
                    wid_t = jnp.take_along_axis(
                        out["wall_in_dir"], itr[:, None], axis=-1
                    )[..., 0]
                    out["wall_sunlit_frac"] = 0.5 * wid_t / jnp.maximum(
                        eps, fwdc * sin0 * int_dir_clear
                    )
                dn_dir_clear = dn_dir_clear * tdc
            return (dn_dir_new, dn_diff_new, dn_dir_clear), out

        # Initial conditions at canopy top (radsurf_urban_sw.F90:687-700)
        dn_dir0 = jnp.zeros((C, S, nreg), dtype)
        dn_diff0 = jnp.zeros((C, S, nd), dtype)
        if with_direct:
            dn_dir0 = dn_dir0.at[..., 0].set(1.0 / zcos[:, None])
            dn_dir_clear0 = 1.0 / zcos
        else:
            dn_diff0 = dn_diff0.at[..., :ns].set(
                jnp.broadcast_to(hw_b, (C, S, ns))
            )
            dn_dir_clear0 = jnp.ones((C,), dtype)

        xs_sweep = (
            lay["R"].swapaxes(0, 1),
            lay["T"].swapaxes(0, 1),
            lay["E"].swapaxes(0, 1),
            lay["Sdn"].swapaxes(0, 1),
            lay["int_dir"].swapaxes(0, 1),
            lay["int_diff"].swapaxes(0, 1),
            lay["int_dir_diff"].swapaxes(0, 1),
            a_above_l, d_above_l, denom_l, a_below_l, d_below_l,
            geo["u_ov"].swapaxes(0, 1),
            geo["v_ov"].swapaxes(0, 1),
            geo["f_wall"].transpose(1, 0, 2),
            f_wall_dir_clear.transpose(1, 0),
            _pad_od(geo["od_scaling"]).transpose(1, 0, 2),
            air_abs_coef.transpose(1, 0, 2),
            veg_abs_coef.transpose(1, 0, 2),
            wall_albedo.transpose(1, 0, 2),
            inp.dz.transpose(1, 0),
            air_ext_t.transpose(1, 0),
            roof_fraction.transpose(1, 0),
            nbf.transpose(1, 0),
            nbf_above.transpose(1, 0),
            trans_dir_clear.transpose(1, 0),
            inp.veg_fraction.transpose(1, 0),
        )
        if opt.associative_sweeps:
            # Log-depth route: the downward recurrence is block-affine in
            # its carry; compose the per-layer maps by suffix associative
            # scan, then vmap down_step for the per-layer outputs.
            from ..ops.assoc_adding import (
                affine_down_carries,
                scalar_suffix_carries,
            )

            v_reg = geo["v_ov"].swapaxes(0, 1)[..., :nreg, :]
            TVr = jnp.einsum(
                "lcsirn,lcrq->lcsiqn",
                xs_sweep[1].reshape(L, C, S, nd, nreg, ns),
                v_reg, precision="highest",
            ).reshape(L, C, S, nd, nd)
            Cmap = solve(denom_l, TVr)
            if with_direct:
                Amap = jnp.einsum(
                    "lcspr,lcrw->lcspw", xs_sweep[2],
                    v_reg, precision="highest",
                )
                SdnV = jnp.einsum(
                    "lcsip,lcpw->lcsiw", xs_sweep[3],
                    v_reg, precision="highest",
                )
                Bmap = solve(denom_l, matmul(
                    xs_sweep[0],
                    matmul(d_above_l, Amap),
                ) + SdnV)
                cs = (nbf / nbf_above * trans_dir_clear).transpose(1, 0)
            else:
                Amap = jnp.broadcast_to(
                    jnp.eye(nreg, dtype=dtype), (L, C, S, nreg, nreg)
                )
                Bmap = jnp.zeros((L, C, S, nd, nreg), dtype)
                cs = jnp.ones((L, C), dtype)
            (dn_dir_in, dn_diff_in), (dn_dir_fin, dn_diff_fin) = (
                affine_down_carries(Amap, Bmap, Cmap, dn_dir0, dn_diff0)
            )
            dn_clear_in, dn_dir_clear_fin = scalar_suffix_carries(
                cs, dn_dir_clear0
            )
            _, outs = jax.vmap(down_step)(
                (dn_dir_in, dn_diff_in, dn_clear_in), xs_sweep
            )
        else:
            (dn_dir_fin, dn_diff_fin, dn_dir_clear_fin), outs = jax.lax.scan(
                down_step, (dn_dir0, dn_diff0, dn_dir_clear0), xs_sweep,
                reverse=True,
            )
        # Per-layer outputs come back stacked [L, C, ...] -> [C, L, ...]
        outs = {k: jnp.moveaxis(v, 0, 1) for k, v in outs.items()}
        # Ground fluxes (radsurf_urban_sw.F90:861-876)
        ground_dn_dir = zcos[:, None] * jnp.sum(dn_dir_fin, axis=-1)
        up_fin = matvec(a_ground, dn_diff_fin)
        if with_direct:
            up_fin = up_fin + matvec(d_ground, dn_dir_fin)
        ground_dn = jnp.sum(dn_diff_fin, axis=-1)
        if with_direct:
            ground_dn = ground_dn + ground_dn_dir
        outs["ground_dn"] = ground_dn
        outs["ground_net"] = ground_dn - jnp.sum(up_fin, axis=-1)
        tan_over_pi = jnp.asarray(np.tile(tan_s, nreg) / Pi, dtype)
        outs["ground_vertical_diff"] = jnp.einsum(
            "csj,j->cs", dn_diff_fin + up_fin, tan_over_pi, precision="highest"
        )
        if with_direct:
            outs["ground_dn_dir"] = ground_dn_dir
            gdd_t = jnp.take_along_axis(ground_dn_dir, itr[:, None], -1)[..., 0]
            outs["ground_sunlit_frac"] = _safe_div(
                gdd_t, zcos * dn_dir_clear_fin
            )
            outs["top_dn_dir"] = jnp.ones((C, S), dtype)
            outs["top_dn"] = jnp.ones((C, S), dtype)
            outs["top_net"] = 1.0 - top_albedo_dir
        else:
            outs["top_dn_dir"] = jnp.zeros((C, S), dtype)
            outs["top_dn"] = jnp.ones((C, S), dtype)
            outs["top_net"] = 1.0 - top_albedo_diff
        return outs

    norm_dir = sweep(with_direct=True)
    norm_diff = sweep(with_direct=False)
    return norm_dir, norm_diff, bc


def _pad_od(od_scaling):
    """[C, L, nreg-1] -> [C, L, max(nreg-1, 1)] (nreg=1: unused zeros)."""
    if od_scaling.shape[-1] == 0:
        return jnp.zeros(od_scaling.shape[:-1] + (1,), od_scaling.dtype)
    return od_scaling


# ----------------------------------------------------------------------
# Longwave solver
# ----------------------------------------------------------------------

def _spartacus_lw_impl(inp: CanopyInputs, opt: SolverOptions,
                       lg: LegendreGauss, with_profiles: bool = False):
    """Longwave solve for one column group.

    Returns (internal, norm, bc): `internal` holds fluxes from emission
    within the canopy, `norm` the fluxes normalized by unit top-of-canopy
    downwelling, and bc = {"top_emissivity", "top_emission"} [C, S].
    Parity: radsurf/radsurf_urban_lw.F90:35-883 (forest =
    radsurf_forest_lw.F90 via building_fraction = 0).
    """
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype = inp.air_ext.dtype
    mu = np.asarray(lg.mu, dtype)
    hw = np.asarray(lg.hweight, dtype)
    tan_s = np.asarray(lg.tan_ang, dtype)
    hw_b = jnp.asarray(hw, dtype)

    geo = _prepare_geometry(inp, opt, lg, lw=True)
    frac = geo["frac"]

    # Wall factors (radsurf_urban_lw.F90:384-392): walls fully intercept;
    # the reference uses the band-1 wall emissivity for the scattering factor
    # (wall_factor = 1 - wall_emissivity(1,:), a quirk); we use the full
    # spectral emissivity (identical for nlw = 1, the only supported case of
    # the reference's simple spectrum).
    if opt.do_urban:
        wall_ext = jnp.ones((C, L, S), dtype)
        wall_factor = 1.0 - inp.wall_emissivity
        wall_emissivity = inp.wall_emissivity
        wall_emission = inp.wall_emission
        roof_emissivity = inp.roof_emissivity
        roof_emission = inp.roof_emission
    else:
        wall_ext = jnp.ones((C, L, S), dtype)
        wall_factor = jnp.zeros((C, L, S), dtype)
        wall_emissivity = jnp.ones((C, L, S), dtype)
        wall_emission = jnp.zeros((C, L, S), dtype)
        roof_emissivity = jnp.ones((C, L, S), dtype)
        roof_emission = jnp.zeros((C, L, S), dtype)

    ext_reg, ssa_reg, planck_reg = G.region_optics_lw(
        inp.air_ext, inp.air_ssa, inp.clear_air_planck,
        inp.veg_ext, inp.veg_ssa, inp.veg_planck, inp.veg_air_planck,
        geo["od_scaling"], nreg,
    )
    _, g1m, g2m, _ = G.assemble_gammas(
        ext_reg, ssa_reg, geo["f_exchange"], geo["f_wall"],
        wall_ext, wall_factor, lg, nreg,
    )
    em = G.emission_rates(
        ext_reg, ssa_reg, planck_reg, frac, geo["norm_perim_wall"],
        wall_emission, lg, nreg,
    )
    dz_b = jnp.broadcast_to(inp.dz[:, :, None], (C, L, S))

    lay = lw_layer_matrices(g1m, g2m, em["emiss_rate"], dz_b,
                            n_double=opt.n_double)

    # Emission bookkeeping (radsurf_urban_lw.F90:446-477)
    emiss_factor = 2.0 * float(np.sum(hw / mu))
    emiss_reg = emiss_factor * em["volume_emiss"]  # [C, L, S, nreg]
    if nreg > 1:
        air_src = (
            inp.air_ext * (1.0 - inp.air_ssa) * inp.veg_air_planck
        )  # clear-air properties (radsurf_urban_lw.F90:466-469)
        emiss_air = emiss_factor * frac[..., None, 1:] * air_src[..., None]
        emiss_veg = (
            emiss_factor
            * frac[..., None, 1:]
            * (inp.veg_ext[..., None] * (1.0 - inp.veg_ssa))[..., None]
            * inp.veg_planck[..., None]
            * geo["od_scaling"][..., None, :]
        )
    else:
        emiss_air = emiss_veg = jnp.zeros((C, L, S, 1), dtype)
    emiss_wall = (
        jnp.sum(geo["norm_perim_wall"], axis=-1)[..., None]
        * lg.vadjustment
        * wall_emission
    )  # [C, L, S]

    # Ground operators (radsurf_urban_lw.F90:551-565)
    block = np.zeros((nreg, ns, nreg, ns))
    for r in range(nreg):
        block[r, :, r, :] = 1.0
    same_reg = jnp.asarray(
        (block * hw[None, :, None, None]).reshape(nd, nd), dtype
    )
    a_ground = (1.0 - inp.ground_emissivity)[:, :, None, None] * same_reg
    src_block = np.zeros((nreg, ns))
    src_block[:, :] = hw
    src_shape = jnp.asarray(src_block.reshape(nd), dtype)
    frac0 = frac[:, 0, :]  # lowest-layer fractions
    source_ground = (
        inp.ground_emission[:, :, None]
        * jnp.repeat(frac0, ns, axis=-1)[:, None, :]
        * src_shape
    )  # [C, S, nd]

    # Exposed-roof fraction at the top of each layer
    # (radsurf_urban_lw.F90:589-599; padding makes the top-of-canopy case
    # automatic).  building_fraction is zeros for forest (_sanitize_forest).
    bf_above = jnp.concatenate(
        [inp.building_fraction[:, 1:], jnp.zeros((C, 1), dtype)], axis=1
    )
    exposed_roof = jnp.maximum(0.0, inp.building_fraction - bf_above)

    def up_step(carry, x):
        a_above, source_above = carry
        R, T, p, u_ov, v_ov, reps, remit, exposed = x
        eye = jnp.eye(nd, dtype=dtype)
        denom = eye - matmul(a_above, R)
        at = solve(denom, matmul(a_above, T))
        a_below_reg = R + matmul(T, at)
        # Eq. 34 (radsurf_urban_lw.F90:583-587)
        src_rhs = solve(denom, source_above + matvec(a_above, p))
        source_below_reg = p + matvec(T, src_rhs)
        a_roof = ((1.0 - reps)[:, :, None, None] * hw[:, None]) * jnp.ones(
            (ns, ns), dtype
        )
        source_roof = (remit * exposed[:, None])[:, :, None] * hw  # [C,S,ns]
        a_below = jnp.zeros((C, S, (nreg + 1) * ns, (nreg + 1) * ns), dtype)
        a_below = a_below.at[..., :nd, :nd].set(a_below_reg)
        a_below = a_below.at[..., nd:, nd:].set(a_roof)
        source_below = jnp.concatenate([source_below_reg, source_roof], -1)
        a_above_new = _u_mat_v(u_ov, a_below, v_ov, ns)
        source_above_new = _u_vec(u_ov, source_below, ns)
        ys = (a_above, source_above, denom, a_below, source_below)
        return (a_above_new, source_above_new), ys

    xs = (
        lay["R"].swapaxes(0, 1),
        lay["T"].swapaxes(0, 1),
        lay["p"].swapaxes(0, 1),
        geo["u_ov"].swapaxes(0, 1),
        geo["v_ov"].swapaxes(0, 1),
        roof_emissivity.transpose(1, 0, 2),
        roof_emission.transpose(1, 0, 2),
        exposed_roof.transpose(1, 0),
    )
    if opt.associative_sweeps:
        # Log-depth route (see the SW twin above): emission rides as a
        # width-1 source channel through the same star composition.
        from ..ops.assoc_adding import (
            ground_star_element,
            lw_layer_star_elements,
            star_prefix,
        )

        elems = lw_layer_star_elements(
            xs[0], xs[1], xs[2],
            xs[3], xs[4],
            (1.0 - xs[5])[..., None, None]
            * (hw[:, None] * jnp.ones((ns, ns), dtype)),
            (xs[6] * xs[7][..., None])[..., None] * jnp.asarray(hw, dtype),
            nreg, ns,
        )
        prefix = star_prefix(
            elems,
            ground_star_element(a_ground, source_ground[..., None], 1),
        )
        a_top, source_top = prefix["Rd"][-1], prefix["Su"][-1][..., 0]
        _, ys = jax.vmap(up_step)(
            (prefix["Rd"][:-1], prefix["Su"][:-1, ..., 0]), xs
        )
    else:
        (a_top, source_top), ys = jax.lax.scan(
            up_step, (a_ground, source_ground), xs
        )
    a_above_l, source_above_l, denom_l, a_below_l, source_below_l = ys

    # Top-of-canopy boundary conditions (radsurf_urban_lw.F90:629-637)
    top_emissivity = 1.0 - jnp.einsum(
        "csij,j->cs", a_top[..., :ns, :ns], hw_b, precision="highest"
    )
    top_emission = jnp.sum(source_top[..., :ns], axis=-1)
    bc = {"top_emissivity": top_emissivity, "top_emission": top_emission}

    air_abs_coef = inp.air_ext * (1.0 - inp.air_ssa)
    veg_abs_coef = inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)

    def sweep(with_source: bool):
        def down_step(carry, x):
            dn = carry
            (R, T, p, int_diff, int_source, a_above, source_above,
             denom, a_below, source_below, u_ov, v_ov, fw, od_l, ab_coef,
             vb_coef, weps, er, ea, ev, ew, dz_l) = x
            dn_below = _ov_vec(v_ov, dn, ns)  # [C, S, (nreg+1)ns]
            up_below = matvec(a_below, dn_below)
            if with_source:
                up_below = up_below + source_below
            out = {}
            out["roof_in"] = jnp.sum(dn_below[..., nd:], axis=-1)
            out["roof_net"] = out["roof_in"] - jnp.sum(
                up_below[..., nd:], axis=-1
            )
            if with_source:
                rhs = (
                    matvec(T, dn_below[..., :nd])
                    + matvec(R, source_above) + p
                )
            else:
                rhs = matvec(T, dn_below[..., :nd])
            dn_new = solve(denom, rhs)
            up_above = matvec(a_above, dn_new)
            if with_source:
                up_above = up_above + source_above
            if with_profiles:
                out["flux_dn_layer_top"] = jnp.sum(dn_below[..., :nd], -1)
                out["flux_up_layer_top"] = jnp.sum(up_below[..., :nd], -1)
                out["flux_dn_layer_base"] = jnp.sum(dn_new, -1)
                out["flux_up_layer_base"] = jnp.sum(up_above, -1)
            conv = dn_below[..., :nd] - dn_new - up_below[..., :nd] + up_above
            int_flux = matvec(int_diff, conv)
            if with_source:
                int_flux = int_flux + int_source
            iflux = int_flux.reshape(C, S, nreg, ns)
            if_mu = jnp.einsum("csrn,n->csr", iflux, 1.0 / mu,
                               precision="highest")
            out["clear_air_abs"] = ab_coef * if_mu[..., 0]
            if nreg > 1:
                out["veg_air_abs"] = ab_coef * jnp.sum(if_mu[..., 1:], -1)
                out["veg_abs"] = vb_coef * jnp.sum(
                    if_mu[..., 1:] * od_l[:, None, :], -1
                )
            if with_source:
                out["clear_air_abs"] = out["clear_air_abs"] - er[..., 0] * dz_l[:, None]
                if nreg > 1:
                    out["veg_air_abs"] = out["veg_air_abs"] - jnp.sum(
                        ea, -1) * dz_l[:, None]
                    out["veg_abs"] = out["veg_abs"] - jnp.sum(
                        ev, -1) * dz_l[:, None]
            if opt.do_urban:
                if_tan = jnp.einsum("csrn,n->csr", iflux, tan_s,
                                    precision="highest")
                wall_in = jnp.einsum("cr,csr->cs", fw, if_tan,
                                     precision="highest")
                out["wall_in"] = wall_in
                wall_net = wall_in * weps
                if with_source:
                    wall_net = wall_net - ew * dz_l[:, None]
                out["wall_net"] = wall_net
            return dn_new, out

        dn0 = jnp.zeros((C, S, nd), dtype)
        if not with_source:
            dn0 = dn0.at[..., :ns].set(jnp.broadcast_to(hw_b, (C, S, ns)))

        xs_sweep = (
            lay["R"].swapaxes(0, 1),
            lay["T"].swapaxes(0, 1),
            lay["p"].swapaxes(0, 1),
            lay["int_diff"].swapaxes(0, 1),
            lay["int_source"].swapaxes(0, 1),
            a_above_l, source_above_l, denom_l, a_below_l, source_below_l,
            geo["u_ov"].swapaxes(0, 1),
            geo["v_ov"].swapaxes(0, 1),
            geo["f_wall"].transpose(1, 0, 2),
            _pad_od(geo["od_scaling"]).transpose(1, 0, 2),
            air_abs_coef.transpose(1, 0, 2),
            veg_abs_coef.transpose(1, 0, 2),
            wall_emissivity.transpose(1, 0, 2),
            emiss_reg.swapaxes(0, 1),
            emiss_air.swapaxes(0, 1),
            emiss_veg.swapaxes(0, 1),
            emiss_wall.transpose(1, 0, 2),
            inp.dz.transpose(1, 0),
        )
        if opt.associative_sweeps:
            # Log-depth route: affine carry maps with the emission constant
            # in the B slot over a frozen width-1 channel pinned at 1.
            from ..ops.assoc_adding import affine_down_carries

            v_reg = geo["v_ov"].swapaxes(0, 1)[..., :nreg, :]
            TVr = jnp.einsum(
                "lcsirn,lcrq->lcsiqn",
                xs_sweep[1].reshape(L, C, S, nd, nreg, ns),
                v_reg, precision="highest",
            ).reshape(L, C, S, nd, nd)
            Cmap = solve(denom_l, TVr)
            if with_source:
                Bmap = solve(denom_l, matvec(
                    xs_sweep[0], source_above_l
                ) + xs_sweep[2])[..., None]
            else:
                Bmap = jnp.zeros((L, C, S, nd, 1), dtype)
            Amap = jnp.ones((L, C, S, 1, 1), dtype)
            one0 = jnp.ones((C, S, 1), dtype)
            (_, dn_in), (_, dn_fin) = affine_down_carries(
                Amap, Bmap, Cmap, one0, dn0
            )
            _, outs = jax.vmap(down_step)(dn_in, xs_sweep)
        else:
            dn_fin, outs = jax.lax.scan(
                down_step, dn0, xs_sweep, reverse=True
            )
        outs = {k: jnp.moveaxis(v, 0, 1) for k, v in outs.items()}
        up_fin = matvec(a_ground, dn_fin)
        if with_source:
            up_fin = up_fin + source_ground
        outs["ground_dn"] = jnp.sum(dn_fin, axis=-1)
        outs["ground_net"] = outs["ground_dn"] - jnp.sum(up_fin, axis=-1)
        tan_over_pi = jnp.asarray(np.tile(tan_s, nreg) / Pi, dtype)
        outs["ground_vertical_diff"] = jnp.einsum(
            "csj,j->cs", dn_fin + up_fin, tan_over_pi, precision="highest"
        )
        if with_source:
            outs["top_dn"] = jnp.zeros((C, S), dtype)
            outs["top_net"] = -top_emission
        else:
            outs["top_dn"] = jnp.ones((C, S), dtype)
            outs["top_net"] = top_emissivity
        return outs

    internal = sweep(with_source=True)
    norm = sweep(with_source=False)
    return internal, norm, bc


# ----------------------------------------------------------------------
# Public entry points: optional column chunking around the impls
# ----------------------------------------------------------------------

# Per-field no-op padding values for chunk-rounding extra columns: scales
# must stay positive (they divide perimeter formulas) and cos_sza nonzero
# (it divides the direct normalization); everything else pads with zero.
_PAD_VALUES = {"cos_sza": 1.0, "veg_scale": 1.0, "building_scale": 1.0}


def _pad_columns(inp: CanopyInputs, pad: int) -> CanopyInputs:
    if pad == 0:
        return inp
    from dataclasses import fields, replace

    kw = {}
    for f in fields(inp):
        x = getattr(inp, f.name)
        if x is None:
            continue
        fill = _PAD_VALUES.get(f.name, 0.0)
        extra = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
        kw[f.name] = jnp.concatenate([jnp.asarray(x), extra], axis=0)
    return replace(inp, **kw)


def _resolve_column_chunk(opt: SolverOptions, lg, C: int, L: int, S: int,
                          itemsize: int) -> int:
    """Resolve the column_chunk sentinel: -1 = AUTO picks the fewest even
    chunks whose working set fits the device's memory share
    (utils/memory.py), and no chunking where the device reports no memory
    limit (the CPU backend)."""
    ck = opt.column_chunk
    if ck != -1:
        return ck
    limit = memory.device_bytes_limit()
    if limit is None:
        return 0
    per_col = memory.solve_bytes_per_column(opt.nreg, lg.nstream, L, S,
                                            itemsize)
    return memory.even_chunk(C, int(memory.SOLVE_SHARE * limit) // per_col)


def _chunked_solve(impl, inp, opt, lg, with_profiles):
    C, L = inp.dz.shape
    ck = _resolve_column_chunk(opt, lg, C, L, inp.air_ext.shape[-1],
                               inp.air_ext.dtype.itemsize)
    if not ck or C <= ck:
        return impl(inp, opt, lg, with_profiles)
    pad = (-C) % ck
    inp_p = _pad_columns(inp, pad)
    n_chunks = (C + pad) // ck
    split = jax.tree_util.tree_map(
        lambda x: jnp.reshape(x, (n_chunks, ck) + x.shape[1:]), inp_p
    )
    out = jax.lax.map(lambda a: impl(a, opt, lg, with_profiles), split)
    return jax.tree_util.tree_map(
        lambda x: jnp.reshape(x, (n_chunks * ck,) + x.shape[2:])[:C], out
    )


def _coerce_dtype(inp: CanopyInputs) -> CanopyInputs:
    """Cast every array field to ONE working dtype (air_ext's).

    Mixed-precision inputs (e.g. f32 optics with f64 Planck emissions)
    would otherwise make the adding-scan carry dtypes diverge mid-solve
    (jax.lax.scan requires carry-in == carry-out types) and silently
    promote parts of the f32 fast path to f64."""
    from dataclasses import fields, replace

    dtype = jnp.asarray(inp.air_ext).dtype
    kw = {}
    for f in fields(inp):
        x = getattr(inp, f.name)
        if x is None:
            continue
        xa = jnp.asarray(x)
        if xa.dtype != dtype:
            kw[f.name] = xa.astype(dtype)
    return replace(inp, **kw) if kw else inp


def _sanitize_forest(inp: CanopyInputs, opt: SolverOptions) -> CanopyInputs:
    """Forest solves must ignore building inputs entirely (the reference's
    forest solvers never read them, radsurf_forest_sw.F90:226-234): input
    files may carry -1 sentinels in building_fraction for forest columns,
    which would otherwise corrupt region fractions, perimeters, roof
    fractions and the clear-sky sunlit recurrences.  Zeroing ONCE here
    keeps every downstream path (scan and associative sweeps) consistent."""
    if opt.do_urban or inp.building_fraction is None:
        return inp
    from dataclasses import replace

    return replace(
        inp, building_fraction=jnp.zeros_like(inp.building_fraction)
    )


@functools.partial(jax.jit, static_argnames=("opt", "lg", "with_profiles"))
def spartacus_sw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False):
    """Shortwave solve; see _spartacus_sw_impl.  Honors opt.column_chunk;
    reverse-mode differentiable."""
    return _chunked_solve(_spartacus_sw_impl,
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles)


@functools.partial(jax.jit, static_argnames=("opt", "lg", "with_profiles"))
def spartacus_lw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False):
    """Longwave solve; see _spartacus_lw_impl.  Honors opt.column_chunk;
    reverse-mode differentiable."""
    return _chunked_solve(_spartacus_lw_impl,
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles)
