"""Streaming column pipeline: overlap host->device transfer with compute.

For datasets larger than DEVICE memory the driver can process the column
axis in chunks while keeping the accelerator busy: while chunk i computes,
chunk i+1's host->device DMA is already in flight, and chunk i-1's outputs
are being fetched.  JAX's asynchronous dispatch provides the overlap for
free as long as we never block on a transfer before enqueueing the next
chunk's work; this helper just sequences device_put / solve / device_get
with a bounded number of in-flight chunks so device memory stays bounded
at ~depth x chunk working sets.  (Host memory is NOT bounded: inputs must
be resident host arrays and outputs are accumulated then concatenated, so
the host holds roughly 2x the output size at peak.)

The reference has no analogue (it is an in-core OpenMP loop,
driver/spartacus_surface_driver.F90:199-234); this is the accelerator
equivalent of processing an unbounded column axis through a fixed-size
device.
"""

from __future__ import annotations

import jax
import numpy as np


def _concat_leaves(parts):
    """Concatenate a list of matching pytrees of host arrays on axis 0."""
    treedef = jax.tree_util.tree_structure(parts[0])
    leaves = [jax.tree_util.tree_leaves(p) for p in parts]
    out = [
        np.concatenate([chunk[i] for chunk in leaves], axis=0)
        for i in range(len(leaves[0]))
    ]
    return jax.tree_util.tree_unflatten(treedef, out)


def stream_columns(solve, arrays, chunk: int, depth: int = 2):
    """Run `solve` over column chunks of `arrays` with transfer/compute
    overlap.

    solve: dict-of-[c, ...]-arrays -> pytree of device arrays with leading
        column axis (e.g. lambda a: run_radsurf(config, a, mesh=mesh)).
    arrays: dict of host arrays, every value with the column axis leading.
    chunk: columns per chunk (the last chunk may be smaller; each distinct
        chunk size compiles its own executable, so datasets should be
        processed in equal chunks when possible).
    depth: maximum chunks in flight on the device (2 = double buffering).

    Returns the solve outputs as HOST arrays concatenated over columns.
    """
    ncol = len(next(iter(arrays.values())))
    bad = {
        k: np.shape(v) for k, v in arrays.items()
        if np.ndim(v) == 0 or len(v) != ncol
    }
    if bad:
        raise ValueError(
            "stream_columns slices every input on axis 0; these arrays do"
            f" not have a leading column axis of length {ncol}: {bad}"
        )
    if chunk <= 0 or chunk >= ncol:
        return jax.device_get(solve(arrays))

    inflight: list = []
    parts: list = []
    for start in range(0, ncol, chunk):
        sl = slice(start, min(start + chunk, ncol))
        # solve() may do host-side planning on the chunk (run_radsurf
        # groups columns by tile type with numpy), so hand it host slices;
        # its jitted internals enqueue the H2D transfers and the compute
        # asynchronously, so this loop never blocks on device work.
        chunk_in = {
            k: np.ascontiguousarray(v[sl]) for k, v in arrays.items()
        }
        inflight.append(solve(chunk_in))  # async dispatch
        if len(inflight) >= depth:
            # Fetch the oldest chunk; blocks only on work enqueued >= depth
            # chunks ago, so the device pipeline stays full.  One batched
            # device_get per chunk, not one transfer per leaf.
            parts.append(jax.device_get(inflight.pop(0)))
    parts.extend(jax.device_get(x) for x in inflight)
    return _concat_leaves(parts)
