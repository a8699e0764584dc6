"""Device-mesh column sharding.

The column axis is embarrassingly parallel — the reference has no
inter-column coupling anywhere (radsurf/radsurf_interface.F90:105-313) and
parallelizes with OpenMP over column blocks
(driver/spartacus_surface_driver.F90:199-234).  The equivalent here is
a 1-D jax.sharding Mesh over all devices with every [C, ...] input sharded
along the leading column axis: the jitted solvers then run SPMD with zero
collectives in the hot path (XLA inserts none because no cross-column
contraction exists).  Cross-device communication appears only in
diagnostics/reductions outside the solve, matching the reference's serial
post-processing (spartacus_surface_driver.F90:250-296).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the column axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only"
                    f" {len(devices)} devices are visible; run under"
                    " XLA_FLAGS=--xla_force_host_platform_device_count="
                    f"{n_devices} (virtual CPU) or on a host with more devices"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("columns",))


def column_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (column) axis, replicate the rest."""
    return NamedSharding(mesh, P("columns"))


def shard_inputs_by_column(inputs, mesh: Mesh):
    """Place every array leaf of a pytree with its leading axis sharded over
    the mesh's column axis.  Leading dims must be divisible by the mesh
    size (pad columns if needed)."""
    sharding = column_sharding(mesh)

    def place(x):
        if x is None:
            return None
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(place, inputs)
