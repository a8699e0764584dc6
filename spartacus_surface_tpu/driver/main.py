"""Offline driver CLI: spartacus_surface config.nam input.nc output.nc.

Parity: program spartacus_surface_driver,
driver/spartacus_surface_driver.F90:20-302 — same three arguments, namelist
handling, benchmark repetition (nrepeat), column-range selection, flux
scaling/summation, optional conservation check and output writing.  Where
the reference parallelizes over OpenMP column blocks
(spartacus_surface_driver.F90:199-234), this driver runs the whole column
batch as jitted device computations (optionally sharded over a device mesh;
see parallel/mesh.py).

Precision: double by default to match the reference's jprb; pass
--precision=single for half the memory and transfer volume (reference
supports the same choice via -DSINGLE_PRECISION, Makefile:42-44).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(
        prog="spartacus_surface",
        description=(
            "SPARTACUS-Surface offline radiation scheme (JAX build)"
        ),
    )
    p.add_argument("namelist", help="Namelist configuration file")
    p.add_argument("input", help="Input NetCDF file")
    p.add_argument("output", help="Output NetCDF file")
    p.add_argument(
        "--precision", choices=("double", "single"), default="double",
        help="Working precision (double matches the reference default)",
    )
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="Capture a JAX profiler trace of the solve into DIR and"
             " print per-region wall times (the reference's Dr-Hook/"
             "GPROF equivalents, Makefile_include.gfortran:40-43)",
    )
    p.add_argument(
        "--timings", action="store_true",
        help="Print per-phase wall times (read_input / radsurf / save) at"
             " exit — the region timers of --profile without the trace"
             " capture",
    )
    p.add_argument(
        "--column-chunk", type=int, default=None, metavar="N",
        help="Solve in column chunks of N (bounds the device working set"
             " for very large inputs; the analogue of the reference's"
             " nblocksize OpenMP blocking). -1 = AUTO (the default: the"
             " fewest chunks that fit the device memory, per shard under a"
             " mesh), 0 = whole batch; overrides the `column_chunk`"
             " namelist extension.",
    )
    p.add_argument(
        "--stream-chunk", type=int, default=None, metavar="N",
        help="Stream the solve over column chunks of N with double-"
             "buffered host->device transfer overlapping compute (for"
             " datasets larger than device/host memory; outputs are"
             " fetched per chunk and reassembled on the host). Differs"
             " from --column-chunk, which keeps everything device-resident"
             " inside one program. Default: auto — streaming engages by"
             " itself when the run's inputs and outputs would not fit the"
             " device memory share of utils/memory.py; 0 disables.",
    )
    p.add_argument(
        "--netcdf4", action="store_true",
        help="Write the output as NetCDF4/HDF5 via the native libnetcdf"
             " backend (default: NetCDF3 classic, as the reference driver)",
    )
    p.add_argument(
        "--mesh", default="auto", metavar="auto|off|N",
        help="Device-mesh column sharding: 'auto' (default) builds a 1-D"
             " mesh over all local devices when more than one is visible,"
             " 'off' forces single-device, an integer N uses the first N"
             " devices. The equivalent of the reference's OpenMP"
             " column blocks (spartacus_surface_driver.F90:199-234).",
    )
    p.add_argument(
        "--platform", choices=("default", "cpu", "gpu"), default="default",
        help="JAX platform; 'default' uses whatever the environment provides"
             " (the GPU when one is present)",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="jax.distributed coordinator address for multi-process runs"
             " (the process-level analogue of the reference's OpenMP"
             " do_parallel; each process solves its own contiguous column"
             " slice and writes OUTPUT.pNN)",
    )
    p.add_argument(
        "--num-processes", type=int, default=None, metavar="N",
        help="Total process count for --coordinator runs",
    )
    p.add_argument(
        "--process-id", type=int, default=None, metavar="I",
        help="This process's rank (0-based) for --coordinator runs",
    )
    p.add_argument(
        "--keep-shards", action="store_true",
        help="Multi-process runs: keep the per-process OUTPUT.pNN shards"
             " after process 0 merges them into the single OUTPUT file",
    )
    return p


def _auto_stream_chunk(config, arrays, ncol: int, n_devices: int = 1,
                       bytes_limit: int | None = None,
                       itemsize: int = 8) -> int:
    """Pick a streaming chunk (0 = stream not needed): the fewest equal
    slices whose inputs and outputs fit the device memory share of
    utils/memory.py on each of n_devices (a mesh splits every buffer over
    its devices).  No limit (the CPU backend) means no streaming."""
    from ..utils import memory

    if not bytes_limit:
        return 0
    nlay = arrays["dz"].shape[1]
    nband = max(config.nswinternal if config.do_sw else 1,
                config.nlwinternal if config.do_lw else 1)
    per_col = memory.io_bytes_per_column(nlay, nband, itemsize)
    max_cols = int(memory.IO_SHARE * bytes_limit) * max(1, n_devices)
    return memory.even_chunk(ncol, max_cols // per_col)


def _stream_solve(config, data, arrays, stream_chunk, mesh,
                  want_budgets=True):
    """Streamed solve with DEVICE-SIDE post-processing per slice.

    Scaling the two normalizations by their top-of-canopy fluxes, summing
    them, and (when the conservation check will run) reducing the budget
    to per-column vectors all happen on device before the slice is
    fetched: the host then pulls ONE summed flux container (plus
    [C]-sized budget vectors) instead of two full normalized containers —
    half the device->host bytes, which dominate very large runs on
    bandwidth-limited links.

    Returns (sw_flux, lw_flux, budgets) as host arrays; budgets maps
    "sw_dir"/"sw_diff"/"lw_int"/"lw_norm" to budget_components dicts
    (per-unit-TOC, what the reference's conservation table shows), and is
    empty when want_budgets is false.
    """
    import jax
    import numpy as np

    from ..models import flux_utils
    from ..models.dispatch import run_radsurf
    from ..parallel.streaming import stream_columns

    scal = {}
    if config.do_sw:
        top_dir = np.asarray(data["top_flux_dn_direct_sw"])
        scal["__top_dir_sw"] = top_dir
        scal["__top_diff_sw"] = np.asarray(data["top_flux_dn_sw"]) - top_dir
    if config.do_lw:
        scal["__top_lw"] = np.asarray(data["top_flux_dn_lw"])
    aug = dict(arrays)
    aug.update(scal)

    # One jitted program for the whole per-slice epilogue (it touches
    # ~100 small arrays per slice, one dispatch each if run eagerly).
    # Cached on the function so nrepeat > 1 (and repeated calls with the
    # same run state) reuse the compiled program instead of re-jitting a
    # fresh closure per call.
    cache = getattr(_stream_solve, "_post_cache", None)
    if (cache is not None and cache[0] is config and cache[1] is mesh
            and cache[2] == want_budgets):
        post = cache[3]
    else:
        @jax.jit
        def post(res, sc, masks):
            out = {"budget": {}}
            if config.do_sw:
                nd = flux_utils.scale_flux(res["sw_norm_dir"],
                                           sc["__top_dir_sw"])
                nf = flux_utils.scale_flux(res["sw_norm_diff"],
                                           sc["__top_diff_sw"])
                out["sw_flux"] = flux_utils.sum_flux(nd, nf)
                if want_budgets:
                    out["budget"]["sw_dir"] = flux_utils.budget_with_masks(
                        res["sw_norm_dir"], masks)
                    out["budget"]["sw_diff"] = flux_utils.budget_with_masks(
                        res["sw_norm_diff"], masks)
            if config.do_lw:
                lw_norm = flux_utils.scale_flux(res["lw_norm"],
                                                sc["__top_lw"])
                out["lw_flux"] = flux_utils.sum_flux(res["lw_internal"],
                                                     lw_norm)
                if want_budgets:
                    out["budget"]["lw_int"] = flux_utils.budget_with_masks(
                        res["lw_internal"], masks)
                    out["budget"]["lw_norm"] = flux_utils.budget_with_masks(
                        res["lw_norm"], masks)
            return out

        _stream_solve._post_cache = (config, mesh, want_budgets, post)

    def slice_solve(a):
        sc = {key: a.pop(key) for key in scal}
        res = run_radsurf(config, a, mesh=mesh)
        masks = flux_utils.representation_masks(a["i_representation"])
        return post(res, sc, masks)

    streamed = stream_columns(slice_solve, aug, stream_chunk)
    return (streamed.get("sw_flux"), streamed.get("lw_flux"),
            streamed["budget"])


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax

    if args.platform != "default":
        jax.config.update("jax_platforms", args.platform)
    if args.precision == "double":
        jax.config.update("jax_enable_x64", True)

    from ..utils import compile_cache

    compile_cache.configure()

    # Multi-process bootstrap (must precede any backend use).  Explicit
    # flags take precedence; otherwise fall back to cluster env
    # auto-detection inside jax.distributed (SLURM and friends).
    if args.num_processes is not None and args.num_processes > 1:
        from ..parallel.distributed import initialize

        initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import numpy as np

    from ..models import flux_utils
    from ..models.dispatch import TILE_NAMES, run_radsurf
    from ..models.simple_spectrum import calc_simple_spectrum_lw
    from ..utils import profiling
    from ..utils.config import Config, DriverConfig
    from .read_input import read_input
    from .save import save_canopy_fluxes

    def fail(msg: str) -> int:
        """Error exit that also tears down the distributed runtime, so
        peers blocked at the shard barrier fail fast instead of timing
        out (they would otherwise see an opaque coordination-service
        error 600 s later)."""
        print(msg, file=sys.stderr)
        if jax.process_count() > 1:
            from ..parallel.distributed import shutdown

            shutdown()
        return 1

    if not os.path.exists(args.namelist):
        return fail(f'*** Error: namelist file "{args.namelist}" not found')
    if not os.path.exists(args.input):
        return fail(f'*** Error: input file "{args.input}" not found')

    config = Config.from_namelist(args.namelist)
    if args.column_chunk is not None:
        config.column_chunk = args.column_chunk
    driver_config = DriverConfig.from_namelist(args.namelist)
    iverbose = driver_config.iverbose
    if args.profile or args.timings:
        profiling.enabled = True
        profiling.reset()
    if args.profile:
        profiling.start_trace(args.profile)

    def log(*a, level=2):
        if iverbose >= level:
            print(*a)

    log("------------------ OFFLINE SPARTACUS-SURFACE RADIATION SCHEME"
        " ------------------")
    dev0 = jax.devices()[0]
    log(f"Backend: {dev0.platform} ({dev0.device_kind},"
        f" {jax.device_count()} device(s))")
    log(f"Floating-point precision: {args.precision}")
    config.consolidate()
    # Config echo at iverbose >= 2 (radsurf_config.F90:275-362, called from
    # spartacus_surface_driver.F90 after consolidate)
    config.print_config(iverbose=iverbose)

    try:
        with profiling.hook("read_input"):
            data = read_input(args.input, config, driver_config,
                              verbose_print=log)
    except KeyError as exc:
        return fail(f"*** Error reading {args.input}: {exc}")
    arrays = data["arrays"]
    ncol = data["ncol"]

    if jax.process_count() > ncol:
        # Every process reads the same input, so all of them take this
        # consistent error exit (no process is left at the barrier with
        # a zero-column slice).
        return fail(
            f"*** Error: {jax.process_count()} processes for only {ncol}"
            " input columns; use at most one process per column"
        )

    # Multi-process execution: each host handles its own contiguous slice
    # of columns end-to-end (columns are embarrassingly parallel; the
    # reference's OpenMP loop has no inter-column coupling).  Output files
    # then carry a .pNN suffix per process.
    proc_suffix = ""
    if jax.process_count() > 1:
        from ..parallel.distributed import host_column_slice

        hsl = host_column_slice(ncol)
        for key, val in list(arrays.items()):
            arrays[key] = val[hsl]
        for key in ("top_flux_dn_sw", "top_flux_dn_direct_sw",
                    "top_flux_dn_lw"):
            if data[key] is not None:
                data[key] = data[key][hsl]
        ncol = hsl.stop - hsl.start
        proc_suffix = f".p{jax.process_index():02d}"
        log(f"Process {jax.process_index()}/{jax.process_count()}:"
            f" columns {hsl.start + 1} to {hsl.stop}")

    # Device mesh over the column axis (parallel/mesh.py)
    mesh = None
    if args.mesh != "off":
        from ..parallel.mesh import make_mesh

        n_local = len(jax.local_devices())
        if args.mesh == "auto":
            if n_local > 1:
                mesh = make_mesh(devices=jax.local_devices())
        else:
            mesh = make_mesh(int(args.mesh))
        if mesh is not None:
            log(f"Parallel: sharding columns over {mesh.devices.size}"
                f" devices (mesh axes {dict(zip(mesh.axis_names, mesh.devices.shape))})")

    # Column-range selection (spartacus_surface_driver.F90:153-164)
    icol1 = driver_config.istartcol
    icol2 = driver_config.iendcol
    if icol2 < 1 or icol2 > ncol:
        icol2 = ncol
    if icol1 > icol2:
        return fail(
            f"*** Error: requested column range ({icol1} to "
            f"{driver_config.iendcol}) is out of the range in the data"
            f" (1 to {ncol})"
        )
    if (icol1, icol2) != (1, ncol):
        sel = slice(icol1 - 1, icol2)
        for key, val in list(arrays.items()):
            arrays[key] = val[sel]
        for key in ("top_flux_dn_sw", "top_flux_dn_direct_sw",
                    "top_flux_dn_lw"):
            if data[key] is not None:
                data[key] = data[key][sel]
        ncol = icol2 - icol1 + 1

    if config.do_lw:
        calc_simple_spectrum_lw(config, arrays)

    if iverbose >= 4:
        # Per-column representation trace (radsurf_interface.F90:126-128,
        # 176-181 at iverbose >= 4)
        for jcol, code in enumerate(arrays["i_representation"], start=1):
            print(f"{jcol:5d}: {TILE_NAMES.get(int(code), '?')},"
                  f" {int(arrays['nlay'][jcol - 1])} layers")

    if args.precision == "single":
        # Single precision is the data's own dtype, so it holds even in a
        # process that enabled jax_enable_x64 for an earlier run.
        def f32(x):
            return x.astype(np.float32) if x.dtype == np.float64 else x

        arrays = {key: f32(val) for key, val in arrays.items()}
        for key in ("top_flux_dn_sw", "top_flux_dn_direct_sw",
                    "top_flux_dn_lw"):
            if data[key] is not None:
                data[key] = f32(data[key])
    if args.stream_chunk is None:
        from ..utils import memory

        args.stream_chunk = _auto_stream_chunk(
            config, arrays, ncol,
            int(mesh.devices.size) if mesh is not None else 1,
            memory.device_bytes_limit(),
            8 if args.precision == "double" else 4)
        if args.stream_chunk:
            log(f"Streaming the solve in {args.stream_chunk}-column"
                " chunks (host pipeline; see --stream-chunk)")

    sw_flux = lw_flux = result = budgets = None
    tstart = time.perf_counter()
    for _ in range(max(1, driver_config.nrepeat)):
        with profiling.hook("radsurf"):
            if args.stream_chunk:
                sw_flux, lw_flux, budgets = _stream_solve(
                    config, data, arrays, args.stream_chunk, mesh,
                    want_budgets=driver_config.do_conservation_check)
            else:
                result = run_radsurf(config, arrays, mesh=mesh)
        if result is not None:
            if config.do_sw:
                sw_norm_dir = flux_utils.scale_flux(
                    result["sw_norm_dir"], data["top_flux_dn_direct_sw"]
                )
                sw_norm_diff = flux_utils.scale_flux(
                    result["sw_norm_diff"],
                    data["top_flux_dn_sw"] - data["top_flux_dn_direct_sw"],
                )
                sw_flux = flux_utils.sum_flux(sw_norm_dir, sw_norm_diff)
            if config.do_lw:
                lw_norm = flux_utils.scale_flux(
                    result["lw_norm"], data["top_flux_dn_lw"]
                )
                lw_flux = flux_utils.sum_flux(result["lw_internal"], lw_norm)
            # Results are asynchronous device arrays; the reference's
            # omp_get_wtime brackets the complete solve, so wait for them.
            # (The streamed path already returned host arrays.)
            jax.block_until_ready((sw_flux, lw_flux))
    elapsed = time.perf_counter() - tstart
    log(f"Time elapsed in radiative transfer: {elapsed:g} seconds")

    if driver_config.do_conservation_check:
        headers = {
            "sw_dir": "Direct shortwave budget: radiation originating"
                      " from direct solar at canopy top",
            "sw_diff": "Diffuse shortwave budget: radiation originating"
                       " from downward diffuse solar at canopy top",
            "lw_int": "Internal longwave budget: radiation originating"
                      " from emission within canopy",
            "lw_norm": "Incoming longwave budget: radiation originating"
                       " from downward longwave at canopy top",
        }
        if budgets is not None:
            # Streamed path: budgets were reduced on device per slice.
            # (Explicit order: pytree flattening sorts dict keys, so the
            # streamed dict iterates alphabetically.)
            for name in ("sw_dir", "sw_diff", "lw_int", "lw_norm"):
                if name in budgets:
                    print(headers[name])
                    flux_utils.print_budget(budgets[name])
        else:
            for name, key in (("sw_dir", "sw_norm_dir"),
                              ("sw_diff", "sw_norm_diff"),
                              ("lw_int", "lw_internal"),
                              ("lw_norm", "lw_norm")):
                if key in (result or {}):
                    print(headers[name])
                    flux_utils.check_flux(result[key], arrays, name)

    with profiling.hook("save"):
        save_canopy_fluxes(args.output + proc_suffix, config, arrays,
                           sw_flux, lw_flux,
                           iverbose=iverbose, is_hdf5_file=args.netcdf4)
    if jax.process_count() > 1:
        # One output file, always — the reference driver's contract
        # (radsurf_save.F90:26): barrier until every process has written
        # its shard, then process 0 merges OUTPUT.pNN -> OUTPUT.
        from ..parallel.distributed import barrier

        from .merge import merge_shards

        barrier("spartacus_shards_written")
        if jax.process_index() == 0:
            merge_shards(args.output, n_processes=jax.process_count(),
                         delete=not args.keep_shards,
                         is_hdf5_file=args.netcdf4)
            log(f"Merged {jax.process_count()} output shards into"
                f" {args.output}")
    if args.profile:
        profiling.stop_trace()
    if args.profile or args.timings:
        profiling.report()
    if args.profile:
        log(f"Profiler trace written to {args.profile}")
    log("-----------------------------------------------------------------"
        "---------------")
    return 0


if __name__ == "__main__":
    sys.exit(main())
