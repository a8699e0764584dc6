"""Benchmark: columns/sec/device for the full SW+LW vegetated-urban solve.

Runs on a GPU only: with no GPU backend it exits nonzero before measuring
anything.  Prints one JSON line per block, the HEADLINE metric LAST; every
line names the platform, device_kind and device count it ran on:
  {"metric": "compile_check_matrix_ok", ...}      AOT pre-flight, all configs
  {"metric": "mesh_sharded_parity", ...}          solver under NamedSharding
  {"metric": "columns_per_sec_per_chip_..._nreg3", ...}  hard RAMI-V config
  {"metric": "..._rami5_62lay_14band_nreg3", ...} flagship RAMI-V shape
  {"metric": "cli_end_to_end_columns_per_sec", ...}  the SHIPPED program:
      driver CLI on a seeded 50k-column RAMI-V-shaped input, read->solve->
      save, conservation-gated, output schema-checked
  {"metric": "grad_step_columns_per_sec_per_chip", ...}  full
      value-and-gradient (retrieval/adjoint) step throughput
  {"metric": "capacity_1M_columns_per_sec_per_chip", ...}
  {"metric": "columns_per_sec_per_chip_sw_lw_urban8lay", "value": N,
   "unit": "columns/s/chip"}                      headline

EVERY block gates the exit code: a failed block prints {"metric", "error"}
and the bench exits nonzero even if the headline measured fine.

Workload (fixed shape): vegetated-urban canopy, 8 layers, 1 spectral
interval, 4 streams/hemisphere, 2 regions, SW (both normalizations) + LW
(internal + incoming) — the full per-timestep work of the offline scheme,
float32, inputs device-resident.  The nreg=3 line is the RAMI-V
configuration (n_vegetation_region=2, 4 streams, nd=12); the rami5 line
runs the shape the reference community submits — 62 layers x 14 spectral
bands x nreg=3 x 4 streams (the reference's test/rami5 scenes are
1 x 62 x 14 columns).

Measurement design (differential in-jit loop):
  * the timestep loop runs INSIDE one jitted program (lax.fori_loop with a
    dynamic trip count), each iteration data-dependent on the previous
    checksum so no step can be elided, reordered or memoized;
  * every solver output feeds the checksum, so nothing is dead-code
    eliminated;
  * the reported time is the DIFFERENCE between a long and a short run of
    the SAME executable divided by the iteration difference — dispatch
    and fetch overheads cancel, leaving device time.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

def _measure(run_n, sw_inp, lw_inp, C, n_short=3, n_long=23):
    """Median differential step time -> columns/sec (one executable)."""
    warm = float(run_n(sw_inp, lw_inp, 1))
    assert np.isfinite(warm)

    def timed(n):
        t0 = time.perf_counter()
        val = float(run_n(sw_inp, lw_inp, n))
        assert np.isfinite(val)
        return time.perf_counter() - t0

    steps = []
    for _ in range(3):
        t_short = timed(n_short)
        t_long = timed(n_long)
        steps.append(max(t_long - t_short, 1e-9) / (n_long - n_short))
    return C / float(np.median(steps))


def _make_run_n(opt, lg, spartacus_sw, spartacus_lw):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run_n(sw_in, lw_in, n):
        def body(i, chain):
            a = dataclasses.replace(
                sw_in,
                veg_ext=sw_in.veg_ext + chain * 1e-30 + i * 1e-9,
            )
            nd, nf, bc = spartacus_sw(a, opt, lg)
            li, ln, lbc = spartacus_lw(lw_in, opt, lg)
            leaves = jax.tree_util.tree_leaves((nd, nf, bc, li, ln, lbc))
            return sum(jnp.sum(x) for x in leaves)

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    return run_n


def _block(fn, metric, emit):
    """Fail-soft block runner: one bad config can never erase the other
    blocks' evidence (round-2 lesson: the nreg=3 compile crash killed the
    whole bench before a single metric printed).  Prints either the
    block's own JSON line or {"metric": ..., "error": tail}; returns
    whether the block succeeded."""
    import traceback

    try:
        fn()
        return True
    except Exception:
        tail = traceback.format_exc()[-1500:]
        emit({"metric": metric, "error": tail})
        return False


def main() -> int:
    import jax

    import __graft_entry__ as g
    import chip_smoke as smoke
    from spartacus_surface_tpu.models.solver import (
        SolverOptions, spartacus_lw, spartacus_sw)
    from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu.utils import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform} only",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}

    def emit(line):
        print(json.dumps({**line, "device": device}), flush=True)

    n_chips = jax.device_count()
    put = lambda x: None if x is None else jax.device_put(x)
    lg4 = LegendreGauss(4)
    # Every named block must succeed for rc == 0 (see module docstring).
    ok: dict[str, bool] = {}

    # --- pre-flight: AOT-compile every solver configuration --------------
    def compile_blk():
        g.compile_check_matrix(verbose=False)
        emit({
            "metric": "compile_check_matrix_ok",
            "value": len(g.ENTRY_CONFIGS),
            "unit": "configs_compiled",
        })

    ok["compile"] = _block(compile_blk, "compile_check_matrix_ok", emit)

    # --- solver under NamedSharding (production mesh path) ---------------
    def mesh_blk():
        from spartacus_surface_tpu.models.dispatch import run_radsurf
        from spartacus_surface_tpu.parallel.mesh import make_mesh
        from spartacus_surface_tpu.utils.config import Config

        config = Config(nsw=1, nlw=1, do_save_flux_profile=True)
        config.consolidate()
        arrays = g._example_arrays(C=2048, L=8, S=1)
        ref = jax.device_get(run_radsurf(config, arrays, mesh=None))
        mesh = make_mesh(n_chips)
        got = jax.device_get(run_radsurf(config, arrays, mesh=mesh))
        err = smoke.max_rel_err(got, ref)
        # Same arithmetic on the same device type; only the sharding
        # annotations differ, so anything beyond f32 reassociation noise
        # is a partitioning bug.
        mesh_ok = err < 1e-6
        emit({
            "metric": "mesh_sharded_parity_max_rel_err",
            "value": err,
            "unit": "rel_err",
            "ok": mesh_ok,
            "n_mesh_devices": int(mesh.devices.size),
        })
        assert mesh_ok, f"mesh parity gate failed: {err}"

    ok["mesh"] = _block(mesh_blk, "mesh_sharded_parity_max_rel_err", emit)

    # --- nreg=3 x 4-stream (RAMI-V flagship config, nd=12) --------------
    def nreg3_blk():
        C3 = 8192
        opt3 = SolverOptions(nreg=3, nstream=4, do_urban=True,
                             column_chunk=-1)
        sw3, lw3 = g._example_inputs(C=C3, L=8, S=1, dtype=np.float32)
        sw3 = jax.tree_util.tree_map(put, sw3)
        lw3 = jax.tree_util.tree_map(put, lw3)
        run3 = _make_run_n(opt3, lg4, spartacus_sw, spartacus_lw)
        cps3 = _measure(run3, sw3, lw3, C3) / n_chips
        emit({
            "metric": "columns_per_sec_per_chip_sw_lw_urban8lay_nreg3",
            "value": round(cps3, 1),
            "unit": "columns/s/chip",
        })

    ok["nreg3"] = _block(
        nreg3_blk, "columns_per_sec_per_chip_sw_lw_urban8lay_nreg3", emit)

    # --- flagship RAMI-V shape: 62 layers x 14 bands x nreg=3 x ns=4 -----
    def rami5_blk():
        C5, L5, S5 = 1024, 62, 14
        opt5 = SolverOptions(nreg=3, nstream=4, do_urban=True,
                             column_chunk=-1)
        sw5, lw5 = g._example_inputs(C=C5, L=L5, S=S5, dtype=np.float32)
        sw5 = jax.tree_util.tree_map(put, sw5)
        lw5 = jax.tree_util.tree_map(put, lw5)
        run5 = _make_run_n(opt5, lg4, spartacus_sw, spartacus_lw)
        cps5 = _measure(run5, sw5, lw5, C5, n_short=1, n_long=4) / n_chips
        emit({
            "metric": "columns_per_sec_per_chip_rami5_62lay_14band_nreg3",
            "value": round(cps5, 1),
            "unit": "columns/s/chip",
        })

    ok["rami5"] = _block(
        rami5_blk, "columns_per_sec_per_chip_rami5_62lay_14band_nreg3", emit)

    # --- production CLI end-to-end (seeded RAMI-V-shaped input, 50k) ---
    def cli_blk():
        import shutil
        import tempfile

        from spartacus_surface_tpu.driver.synthetic_input import (
            DEPLOYMENTS, write_deployment)

        tmp = tempfile.mkdtemp(prefix="spartacus_cli_e2e_")
        ncol = DEPLOYMENTS["rami"]["ncol"]
        nam, inp = write_deployment("rami", tmp, seed=0)
        outp = f"{tmp}/out.nc"
        # The program the reference ships: namelist -> NetCDF read ->
        # solver -> conservation check -> NetCDF write, run in this
        # process and judged as chip_smoke.py judges it.
        phases, _ = smoke.run_cli(nam, inp, outp, "single")
        figures = smoke.check_output("cli rami single", outp, "single",
                                     ncol, smoke.SCHEMA_RAMI)
        shutil.rmtree(tmp, ignore_errors=True)  # several GB of scratch
        total = sum(phases.values())
        emit({
            "metric": "cli_end_to_end_columns_per_sec",
            "value": round(ncol / total, 1),
            "unit": "columns/s/chip",
            "ncol": ncol,
            "read_s": round(phases["read_input"], 1),
            "solve_s": round(phases["radsurf"], 1),
            "save_s": round(phases["save"], 1),
            "conservation_max_residual": max(
                f["max"] for f in figures.values()),
        })

    ok["cli"] = _block(cli_blk, "cli_end_to_end_columns_per_sec", emit)

    # --- backward pass: full forward+gradient step throughput ------------
    def grad_blk():
        import jax.numpy as jnp

        Cg = 4096
        optg = SolverOptions(nreg=2, nstream=4, do_urban=True)
        swg, lwg = g._example_inputs(C=Cg, L=8, S=1, dtype=np.float32)
        swg = jax.tree_util.tree_map(put, swg)
        lwg = jax.tree_util.tree_map(put, lwg)

        def loss(veg_ext, sw_in, lw_in):
            a = dataclasses.replace(sw_in, veg_ext=veg_ext)
            nd, nf, bc = spartacus_sw(a, optg, lg4)
            li, ln, lbc = spartacus_lw(lw_in, optg, lg4)
            leaves = jax.tree_util.tree_leaves((nd, nf, bc, li, ln, lbc))
            return sum(jnp.sum(x) for x in leaves)

        gfun = jax.grad(loss)

        @jax.jit
        def run_n(sw_in, lw_in, n):
            def body(i, chain):
                ve = sw_in.veg_ext + chain * 1e-30 + i * 1e-9
                return jnp.sum(gfun(ve, sw_in, lw_in))

            return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

        cps = _measure(run_n, swg, lwg, Cg, n_short=1, n_long=6) / n_chips
        emit({
            "metric": "grad_step_columns_per_sec_per_chip",
            "value": round(cps, 1),
            "unit": "columns/s/chip",
        })

    ok["grad"] = _block(grad_blk, "grad_step_columns_per_sec_per_chip", emit)

    # --- 1M-column single-chip capacity (column_chunk streaming) ---------
    def capacity_blk():
        C1m = 1048576
        # AUTO chunking (the production default through run_radsurf):
        # the fewest column chunks whose working set fits the device
        # memory (utils/memory.py).
        opt1m = SolverOptions(
            nreg=2, nstream=4, do_urban=True, column_chunk=-1
        )
        sw1, lw1 = g._example_inputs(C=C1m, L=8, S=1, dtype=np.float32)
        sw1 = jax.tree_util.tree_map(put, sw1)
        lw1 = jax.tree_util.tree_map(put, lw1)
        run1 = _make_run_n(opt1m, lg4, spartacus_sw, spartacus_lw)
        cps1 = _measure(run1, sw1, lw1, C1m, n_short=1, n_long=4) / n_chips
        emit({
            "metric": "capacity_1M_columns_per_sec_per_chip",
            "value": round(cps1, 1),
            "unit": "columns/s/chip",
        })

    ok["capacity"] = _block(capacity_blk, "capacity_1M_columns_per_sec_per_chip", emit)

    # --- headline: nreg=2 x 4-stream ------------------------------------
    def headline_blk():
        C = 16384
        opt = SolverOptions(nreg=2, nstream=4, do_urban=True,
                            column_chunk=-1)
        sw_inp, lw_inp = g._example_inputs(C=C, L=8, S=1, dtype=np.float32)
        sw_inp = jax.tree_util.tree_map(put, sw_inp)
        lw_inp = jax.tree_util.tree_map(put, lw_inp)
        run_n = _make_run_n(opt, lg4, spartacus_sw, spartacus_lw)
        cols_per_sec_per_chip = _measure(run_n, sw_inp, lw_inp, C) / n_chips
        emit({
            "metric": "columns_per_sec_per_chip_sw_lw_urban8lay",
            "value": round(cols_per_sec_per_chip, 1),
            "unit": "columns/s/chip",
        })

    ok["headline"] = _block(
        headline_blk, "columns_per_sec_per_chip_sw_lw_urban8lay", emit)

    # Self-gating: EVERY block must have succeeded (compile pre-flight,
    # the mesh parity gate, and every throughput measurement).
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
