"""Smoke test of SPARTACUS-Surface on one GPU, through the CLI's entry point.

Runs, in this one process (a second JAX process could not reserve the card):

  compile  AOT-compile __graft_entry__.entry_matrix() in f32 and f64 and
           hold each program's transient bytes to utils/memory.py's
           per-entry figure;
  kernels  ops/matrix.py solve / inv / expm_pade7 on the card against
           scipy in f64 at N = 18, 27 and 51 (the headline system, nreg=3
           and the largest, nreg=3 x 8 streams);
  parity   a seeded sample of the two deployments below against the plain
           NumPy reference tests/pyref in f64, and the card's f32 against
           its f64;
  cli      driver.main.main(argv) on the two deployments of
           spartacus_surface_tpu/driver/synthetic_input.py: "coupled"
           (131,072 columns of all six tile types, 8 layers, nreg=2) in
           double and single precision, and "rami" (50,048 RAMI-V-shaped
           columns, 62 layers x 14 SW bands, nreg=3) in single precision;
           checks finite outputs, the output schema, energy
           conservation, and peak device memory against the budget of
           utils/memory.py.

`--four-cards` runs only the mesh phase instead: the coupled deployment
with `--mesh auto` over four cards against `--mesh off` on card 0.

With no GPU backend (or outside a checkout of the repository) it exits
nonzero before printing any result.  The last line of its output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

Usage:  python chip_smoke.py [--four-cards] [--seed S]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chip_smoke_out")

# Conservation bounds on |budget residual| / top-of-canopy downwelling
# flux for the layered SPARTACUS and flat tiles: (max, median) over the
# columns.  The solver closes the budget to rounding (PARITY_NOTES.md,
# "Conservation is exact") except where an exposed roof is narrower than
# the reference's excision threshold (min_building_fraction = 1e-6): the
# column then leaks O(roof fraction) of the fluxes, exactly as the NumPy
# reference tests/pyref does (tests/test_solver_conservation.py,
# test_near_empty_roof_leaks_as_the_reference).  That bounds the max in
# double precision: 9 of the 87,382 layered and flat coupled columns
# (seed 0) leak up to 2.3e-7 (SW) and 1.5e-6 (LW) of the top flux, and
# pyref's own residuals on those columns agree to 1e-11.  The median
# holds the bulk to the precision's rounding.
# The simple-urban tiles are reported but not bounded: the reference's own
# LW scheme for them does not close the budget (simple_urban.py, the
# ground-emissivity quirk), and this build keeps its quirk.
CONSERVATION_BOUND = {"double": (1e-5, 1e-12), "single": (1e-4, 1e-5)}
# f32 against f64 on the card (tests/test_precision.py): the boundary
# fluxes per unit top-of-canopy flux, and the LW emission terms in W m-2.
F32_RTOL, F32_ATOL = 2e-3, 2e-4
_F32_NORM = {"ground_dn": F32_ATOL, "ground_net": F32_ATOL,
             "top_net": F32_ATOL}
F32_GATED = {
    "sw_norm_dir": _F32_NORM, "sw_norm_diff": _F32_NORM,
    "lw_norm": _F32_NORM,
    "lw_internal": {"ground_net": 0.3, "top_net": 0.3},
    "bc_out": {"sw_albedo": F32_ATOL, "sw_albedo_dir": F32_ATOL,
               "lw_emissivity": F32_ATOL, "lw_emission": 0.3},
}
# Mesh against single device: per-column results have no cross-device
# reduction, but XLA may pick other algorithms for another batch size.
MESH_BOUND = {"double": 1e-12, "single": 1e-6}


SCHEMA_COUPLED = ("height", "surface_type", "ground_flux_net_sw",
                  "top_flux_net_sw", "ground_flux_net_lw", "top_flux_net_lw")
SCHEMA_RAMI = SCHEMA_COUPLED + (
    "ground_spectral_flux_dn_sw", "spectral_flux_dn_layer_top_sw",
    "ground_sunlit_fraction", "wall_spectral_flux_net_sw")


class SmokeFailure(Exception):
    """A phase's check failed; main() reports it and exits nonzero."""


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def require_gpu():
    """The platform check that precedes everything else."""
    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as exc:
        fail(f"JAX found no device: {exc}")
    if dev.platform != "gpu":
        fail(f"needs a GPU; JAX found platform {dev.platform!r} only")
    log_card()


def log_card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip())


def device_info():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats().get("peak_bytes_in_use")


def max_rel_err(a, b):
    """max |a - b| / max(1, max |b|) per leaf, over every leaf of two
    pytrees: each field is normalised by its own magnitude, since several
    outputs (veg_abs, wall_net) are small residuals of large cancellations
    where an element's own relative error means nothing."""
    import jax

    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        scale = max(1.0, float(np.abs(y).max(initial=0.0)))
        worst = max(worst, float(np.abs(x - y).max(initial=0.0)) / scale)
    return worst


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_compile():
    """AOT-compile every entry configuration and hold its transient bytes
    to the figure utils/memory.py sizes batches with."""
    import __graft_entry__ as g
    from spartacus_surface_tpu.utils import memory

    C, L, S = g.ENTRY_SHAPE
    for dtype in (np.float32, np.float64):
        item = np.dtype(dtype).itemsize
        results = g.compile_check_matrix(False, dtype)
        for (nreg, ns), (name, secs, ma) in zip(g.ENTRY_CONFIGS, results):
            n = 2 * nreg * ns + nreg
            temp = ma.temp_size_in_bytes
            model = C * memory.solve_bytes_per_column(nreg, ns, L, S, item)
            log(f"compile {name} {np.dtype(dtype).name}: {secs:.1f} s,"
                f" temp {temp} B ({temp / (C * L * S * n * n * item):.2f} B"
                f" per matrix entry and byte of precision; memory model"
                f" {model} B), arguments {ma.argument_size_in_bytes} B,"
                f" outputs {ma.output_size_in_bytes} B")
            if temp > model:
                fail(f"compile {name}: transients exceed utils/memory.py's"
                     " model")
    log("compile: every matrix product asks for HIGHEST precision"
        " (no TF32)")


def phase_kernels():
    import scipy.linalg

    from spartacus_surface_tpu.ops import matrix as M

    rng = np.random.default_rng(0)
    for n in (18, 27, 51):
        a = rng.standard_normal((256, n, n))
        a[:, np.arange(n), np.arange(n)] = np.abs(a).sum(-1) + 1.0
        b = rng.standard_normal((256, n, n))
        solve_err = np.abs(np.asarray(M.solve(a, b))
                           - np.linalg.solve(a, b)).max()
        inv_err = np.abs(np.asarray(M.inv(a)) - np.linalg.inv(a)).max()
        g = rng.standard_normal((64, n, n))
        g = 0.4 * g / np.abs(g).sum(-1).max(-1)[:, None, None]
        expm_err = np.abs(np.asarray(M.expm_pade7(g)) - np.stack(
            [scipy.linalg.expm(x) for x in g])).max()
        log(f"kernels N={n}: solve {solve_err:.2e}, inv {inv_err:.2e},"
            f" expm {expm_err:.2e} (max abs error against scipy, f64)")
        if not (solve_err < 1e-10 and inv_err < 1e-10 and expm_err < 1e-12):
            fail(f"kernels N={n} outside 1e-10 / 1e-10 / 1e-12")


def _load_sample(nam, inp, n_per_tile, seed, cos_sza=None):
    """Read a deployment's input and keep a seeded sample of n_per_tile
    columns of each layered tile type."""
    from spartacus_surface_tpu.driver.read_input import read_input
    from spartacus_surface_tpu.models.simple_spectrum import (
        calc_simple_spectrum_lw)
    from spartacus_surface_tpu.utils.config import Config, DriverConfig
    from pyref.harness import PYREF_TILES

    config = Config.from_namelist(nam)
    config.do_save_flux_profile = True  # exercise the profile outputs
    config.consolidate()
    dc = DriverConfig.from_namelist(nam)
    if cos_sza is not None:
        dc.cos_sza_override = cos_sza
    arrays = read_input(inp, config, dc)["arrays"]
    rng = np.random.default_rng(seed)
    rep = np.asarray(arrays["i_representation"])
    pools = [np.nonzero(rep == t)[0] for t in PYREF_TILES]
    idx = np.sort(np.concatenate([
        rng.choice(pool, min(n_per_tile, pool.size), replace=False)
        for pool in pools]))
    arrays = {k: v[idx] for k, v in arrays.items()}
    calc_simple_spectrum_lw(config, arrays)
    return config, arrays


def _check_parity(tag, config, arrays, rtol, atol, rtol_fields):
    import jax

    from spartacus_surface_tpu.models.dispatch import run_radsurf
    from pyref.harness import pyref_radsurf

    oracle = pyref_radsurf(config, arrays)
    got = jax.device_get(run_radsurf(config, arrays))
    worst, worst_key = 0.0, None
    for group in oracle:
        for key, want in oracle[group].items():
            have = np.asarray(got[group][key], np.float64)
            tol = atol + rtol_fields.get(key, rtol) * np.abs(want)
            ratio = float((np.abs(have - want) / tol).max(initial=0.0))
            if ratio > worst:
                worst, worst_key = ratio, f"{group}.{key}"
    log(f"parity {tag} f64 vs pyref: worst |error| / tolerance = "
        f"{worst:.2e} ({worst_key}; rtol {rtol:g}, atol {atol:g})")
    if worst > 1.0:
        fail(f"parity {tag}: {worst_key} outside tolerance")

    f32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
           for k, v in arrays.items()}
    got32 = jax.device_get(run_radsurf(config, f32))
    worst = {}
    for group in got:
        for key, want in got[group].items():
            gate = F32_GATED.get(group, {}).get(key)
            if gate is None:
                continue
            want = np.asarray(want, np.float64)
            have = np.asarray(got32[group][key], np.float64)
            tol = gate + F32_RTOL * np.abs(want)
            worst[f"{group}.{key}"] = float(
                (np.abs(have - want) / tol).max(initial=0.0))
    key = max(worst, key=worst.get)
    log(f"parity {tag} f32 vs f64 on the card: worst |error| / tolerance"
        f" = {worst[key]:.2e} ({key}; rtol {F32_RTOL:g}, atol"
        f" {F32_ATOL:g} per unit flux, 0.3 W m-2 for LW emission)")
    if worst[key] > 1.0:
        fail(f"parity {tag} f32: {key} outside tolerance")


def phase_parity(dirs, seed):
    from pyref.tolerances import ATOL, RAMI5_RTOL_FIELDS, RTOL

    config, arrays = _load_sample(*dirs["coupled"][:2], 16, seed)
    _check_parity("coupled", config, arrays, RTOL, ATOL, {})
    # RAMI-V scenes at the reference suite's own illumination (40 deg)
    config, arrays = _load_sample(*dirs["rami"][:2], 4, seed,
                                  cos_sza=float(np.cos(np.deg2rad(40.0))))
    _check_parity("rami", config, arrays, RTOL, 1e-6, RAMI5_RTOL_FIELDS)


def run_cli(nam, inp, out, precision, extra=()):
    """driver.main.main in this process with --timings; returns
    ({"read_input", "radsurf", "save": seconds}, whole-call seconds)."""
    import jax

    from spartacus_surface_tpu.driver.main import main as cli_main

    jax.config.update("jax_enable_x64", precision == "double")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([nam, inp, out, "--precision", precision,
                       "--timings", *extra])
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        fail(f"CLI exit {rc} on {inp} ({precision}):\n{text[-2000:]}")
    phases = {k: float(v) for k, v in re.findall(
        r"^\s+(radsurf|save|read_input)\s+([0-9.eE+-]+) s", text, re.M)}
    if set(phases) != {"radsurf", "save", "read_input"}:
        fail(f"CLI on {inp} ({precision}): no timings in\n{text[-2000:]}")
    return phases, secs


def read_output(path):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    out = {name: np.array(v[:]) for name, v in f.variables.items()}
    dims = dict(f.dimensions)
    f.close()
    return out, dims


def conservation(out, band):
    """Per-column |budget residual| / top downwelling flux, from the
    output file (cf. tests/test_reference_cases.budget_residual)."""
    def lay_sum(name):
        v = out.get(name)
        if v is None:
            return 0.0
        return np.where(v == -9999.0, 0.0, v.astype(np.float64)).sum(-1)

    res = (out[f"ground_flux_net_{band}"].astype(np.float64)
           + lay_sum(f"clear_air_absorption_{band}")
           + lay_sum(f"wall_flux_net_{band}")
           + lay_sum(f"roof_flux_net_{band}")
           + lay_sum(f"veg_absorption_{band}")
           + lay_sum(f"veg_air_absorption_{band}")
           - out[f"top_flux_net_{band}"])
    top = np.maximum(np.abs(out[f"top_flux_dn_{band}"]), 1.0)
    return np.abs(res) / top


def check_output(tag, path, precision, ncol, schema):
    """Check a CLI output file: column count, schema, finite values and
    energy conservation inside CONSERVATION_BOUND.  Returns, per band,
    the conservation figures of the layered and flat columns:
    {"sw"|"lw": {"max", "median", "above_1e-12", "columns",
    "simple_urban_max"}}."""
    out, dims = read_output(path)
    if dims["column"] != ncol:
        fail(f"{tag}: {dims['column']} output columns, expected {ncol}")
    missing = [name for name in schema if name not in out]
    if missing:
        fail(f"{tag}: output lacks {missing}")
    for name, val in out.items():
        if val.dtype.kind == "f" and not np.isfinite(
                val[val != -9999.0]).all():
            fail(f"{tag}: non-finite values in {name}")
    rep = out["surface_type"]
    bounded = np.isin(rep, (0, 1, 2, 3))
    max_bound, median_bound = CONSERVATION_BOUND[precision]
    figures = {}
    for band in ("sw", "lw"):
        res = conservation(out, band)
        figures[band] = {
            "max": float(res[bounded].max()),
            "median": float(np.median(res[bounded])),
            "above_1e-12": int((res[bounded] > 1e-12).sum()),
            "columns": int(bounded.sum()),
            "simple_urban_max": float(res[~bounded].max(initial=0.0)),
        }
        if (figures[band]["max"] > max_bound
                or figures[band]["median"] > median_bound):
            fail(f"{tag}: {band} conservation residual outside its bounds"
                 f" {figures[band]}")
    return figures


def budget_bytes(name, nam, precision):
    """Device bytes utils/memory.py allows one CLI run of a deployment: a
    streamed slice's inputs and outputs plus, for each layered tile type
    in it, the transients of its largest solve chunk (summed, as if XLA
    reused no buffer between the tile types' solves)."""
    from spartacus_surface_tpu.driver.synthetic_input import DEPLOYMENTS
    from spartacus_surface_tpu.models.dispatch import _solver_groups
    from spartacus_surface_tpu.utils import memory
    from spartacus_surface_tpu.utils.config import Config

    d = DEPLOYMENTS[name]
    config = Config.from_namelist(nam)
    config.consolidate()
    item = 8 if precision == "double" else 4
    limit = memory.device_bytes_limit()
    nlay, nband = d["nlay"], max(d["nsw"], d["nlw"])
    io_col = memory.io_bytes_per_column(nlay, nband, item)
    cols = min(d["ncol"], int(memory.IO_SHARE * limit) // io_col)
    total = cols * io_col
    groups = _solver_groups(config)
    for tile in set(d["tiles"]) & set(groups):
        kw, lg_sw, lg_lw = groups[tile]
        per_col = max(memory.solve_bytes_per_column(
            kw["nreg"], lg.nstream, nlay, nband, item) for lg in (lg_sw, lg_lw))
        tile_cols = -(-cols // len(d["tiles"]))
        total += min(tile_cols,
                     int(memory.SOLVE_SHARE * limit) // per_col) * per_col
    return total


def phase_cli(dirs):
    runs = (("coupled", "double", SCHEMA_COUPLED),
            ("coupled", "single", SCHEMA_COUPLED),
            ("rami", "single", SCHEMA_RAMI))
    # peak_bytes_in_use is the process's peak so far, so it is held to the
    # largest budget of the runs so far.
    budget = 0
    for name, precision, schema in runs:
        nam, inp, ncol = dirs[name]
        tag = f"{name} {precision}"
        out = os.path.join(OUT_DIR, f"{name}_{precision}_out.nc")
        phases, secs = run_cli(nam, inp, out, precision)
        budget = max(budget, budget_bytes(name, nam, precision))
        peak = peak_bytes()
        log(f"cli {tag}: {ncol} columns, read {phases['read_input']:.3f} s,"
            f" solve {phases['radsurf']:.3f} s, save {phases['save']:.3f} s,"
            f" whole call {secs:.3f} s, peak_bytes_in_use {peak} (memory"
            f" model's budget {budget})")
        if peak > budget:
            fail(f"cli {tag}: peak bytes above utils/memory.py's budget")
        figures = check_output(tag, out, precision, ncol, schema)
        max_bound, median_bound = CONSERVATION_BOUND[precision]
        log(f"cli {tag}: every output variable finite")
        for band, f in figures.items():
            log(f"cli {tag}: {band} conservation |residual| / top flux,"
                f" layered+flat: max {f['max']:.2e}, median"
                f" {f['median']:.2e} (bounds {max_bound:g},"
                f" {median_bound:g}), columns above 1e-12:"
                f" {f['above_1e-12']} of {f['columns']}; simple-urban max"
                f" {f['simple_urban_max']:.2e} (not bounded)")
        os.remove(out)


def phase_four_cards(dirs):
    import jax

    if len(jax.devices()) < 4:
        fail(f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    nam, inp, ncol = dirs["coupled"]
    for precision in ("double", "single"):
        outs = {}
        for mesh in ("off", "auto"):
            path = os.path.join(OUT_DIR, f"mesh_{mesh}_{precision}.nc")
            _, secs = run_cli(nam, inp, path, precision, ("--mesh", mesh))
            log(f"mesh {mesh} {precision}: {ncol} columns on"
                f" {1 if mesh == 'off' else len(jax.devices())} card(s),"
                f" whole call {secs:.3f} s")
            outs[mesh], _ = read_output(path)
            os.remove(path)
        worst = max_rel_err(
            {k: v for k, v in outs["auto"].items()
             if v.dtype.kind == "f"},
            {k: v for k, v in outs["off"].items() if v.dtype.kind == "f"})
        log(f"mesh {precision}: 4-card vs 1-card max relative difference"
            f" {worst:.3e} (bound {MESH_BOUND[precision]:g})")
        if worst > MESH_BOUND[precision]:
            fail(f"mesh {precision}: sharded run differs from single card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phase")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        return run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1


def run(args) -> int:
    require_gpu()
    # The package and the NumPy reference tests/pyref, from this checkout
    # (tests/ is put on the path by itself: another installed package may
    # own the name "tests").
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    try:
        from spartacus_surface_tpu.driver.synthetic_input import (
            DEPLOYMENTS, write_deployment)
        from spartacus_surface_tpu.utils import compile_cache
    except ImportError as exc:
        fail(f"run from a checkout of the repository ({exc})")
    import jax

    jax.config.update("jax_enable_x64", True)
    log(f"compile cache: {compile_cache.configure()}")
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    dirs = {}
    for name in ("coupled",) if args.four_cards else DEPLOYMENTS:
        nam, inp = write_deployment(name, os.path.join(OUT_DIR, name),
                                    seed=args.seed)
        dirs[name] = (nam, inp, DEPLOYMENTS[name]["ncol"])
    log(f"inputs: {', '.join(dirs)} written in"
        f" {time.perf_counter() - t0:.1f} s")

    if args.four_cards:
        phases = (("mesh", lambda: phase_four_cards(dirs)),)
    else:
        phases = (("compile", phase_compile), ("kernels", phase_kernels),
                  ("parity", lambda: phase_parity(dirs, args.seed)),
                  ("cli", lambda: phase_cli(dirs)))
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    log_card()
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
