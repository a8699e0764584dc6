"""Multi-host distributed execution scaffolding.

The reference's only parallelism is shared-memory OpenMP over column blocks
(driver/spartacus_surface_driver.F90:199-234).  The multi-process
equivalent:

  1. `initialize()` — jax.distributed bootstrap, one card per process
     (no-op for a single process);
  2. each host reads ITS OWN slice of the input columns
     (`host_column_slice`), so the input pipeline scales with hosts;
  3. the global column axis is sharded over all devices of all hosts via
     `make_global_mesh` + `jax.make_array_from_process_local_data`;
  4. the solve is SPMD with zero collectives (no inter-column coupling);
  5. diagnostics reduce with jnp.sum over sharded arrays (XLA inserts the
     cross-device sum), mirroring the reference's serial post-processing
     (driver/spartacus_surface_driver.F90:250-296).

Steps 3-4 involve no cross-device traffic at all; only step 5's scalar
reductions and any output gathers cross devices.
"""

from __future__ import annotations

import os
import subprocess

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bootstrap the JAX distributed runtime (multi-process).  A no-op for
    single-process runs.  Each process binds one local GPU (see
    local_device_ids), so processes sharing a host never open each
    other's cards."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids(process_id, num_processes,
                                          count_local_gpus()),
    )


def local_device_ids(process_id, num_processes, n_local: int):
    """The local devices process `process_id` binds: one card each, round
    robin over the host's n_local cards (ranks are assumed contiguous per
    host, as launchers number them).  None = bind nothing — a single
    process, no cards (CPU runs), or the rank unknown (a cluster launcher
    that JAX auto-detects)."""
    if process_id is None or num_processes is None or num_processes <= 1:
        return None
    if n_local <= 0:
        return None
    return [process_id % n_local]


def count_local_gpus() -> int:
    """Number of NVIDIA GPUs this process may use, found without starting
    a JAX backend (jax.distributed.initialize must come first):
    CUDA_VISIBLE_DEVICES when set, else `nvidia-smi -L`; 0 without
    either."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([v for v in visible.split(",") if v.strip()])
    try:
        listing = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return 0
    return sum(line.startswith("GPU ") for line in listing.splitlines())


def shutdown() -> None:
    """Best-effort teardown of the distributed runtime.

    Called on early error exits (bad input, out-of-range column
    selection) so peer processes blocked in wait_at_barrier lose the
    coordinator and fail fast with a disconnect error, instead of
    sitting out the full barrier timeout and surfacing an opaque
    coordination-service message in place of the real failure."""
    if jax.process_count() <= 1:
        return
    try:
        jax.distributed.shutdown()
    except Exception:
        pass


def barrier(name: str, timeout_s: int = 600) -> None:
    """Cross-process barrier via the coordination service.

    Preferred over multihost_utils.sync_global_devices for control-flow
    sync (e.g. "all shards written"): it is a pure KV-store rendezvous
    with a configurable timeout, whereas a device-collective barrier
    has a short (~30 s) setup deadline that trips when
    processes reach it at different times (uneven column counts make
    compile times genuinely different per process)."""
    if jax.process_count() <= 1:
        return
    try:
        from jax._src.distributed import global_state

        client = global_state.client
    except Exception:
        client = None
    if client is not None:
        client.wait_at_barrier(name, timeout_in_ms=timeout_s * 1000)
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def make_global_mesh() -> Mesh:
    """1-D mesh over every device of every host, column axis."""
    return Mesh(np.asarray(jax.devices()), ("columns",))


def host_column_slice(ncol_global: int) -> slice:
    """The contiguous slice of global columns this host should read.

    Balanced split: the first ncol % nproc hosts take one extra column, so
    every host gets >= 1 column whenever nproc <= ncol (a ceil-division
    split would hand trailing hosts zero columns on uneven counts).  Each
    host loads only its shard of the input file (the reference reads
    everything on the single process)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    base, rem = divmod(ncol_global, nproc)
    start = pid * base + min(pid, rem)
    return slice(start, start + base + (1 if pid < rem else 0))


def global_column_array(local_arrays, mesh: Mesh, ncol_global: int):
    """Assemble process-local column shards into global sharded arrays.

    local_arrays: pytree of numpy arrays holding THIS host's columns along
    axis 0.  Returns the same pytree as global jax.Arrays sharded over the
    mesh's column axis.
    """
    sharding = NamedSharding(mesh, P("columns"))

    def build(x):
        if x is None:
            return None
        global_shape = (ncol_global,) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x), global_shape
        )

    return jax.tree_util.tree_map(build, local_arrays)


def pad_columns(arrays: dict, multiple: int) -> tuple[dict, int]:
    """Pad the column axis of a dense input dict to `multiple` by
    replicating the last column (its outputs are discarded).  Returns the
    padded dict and the original column count."""
    ncol = next(v.shape[0] for v in arrays.values() if hasattr(v, "shape"))
    pad = (-ncol) % multiple
    if pad == 0:
        return arrays, ncol
    out = {}
    for key, val in arrays.items():
        if hasattr(val, "shape") and val.ndim >= 1 and val.shape[0] == ncol:
            out[key] = np.concatenate(
                [val, np.repeat(val[-1:], pad, axis=0)], axis=0
            )
        else:
            out[key] = val
    return out, ncol
