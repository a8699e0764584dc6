"""Device-memory budget: how many columns one device program may take.

Every column x layer x band element of a solve carries its own small
matrices: the (2 nd + nreg)-square Pade/doubling working set of the layer
factory (ops/layer_matrices.py) and the interface-operator stacks of the
adding sweeps.  So a solve's footprint is linear in the batch, and the
solver (AUTO column_chunk) and the CLI (automatic --stream-chunk) size
their batches from the per-element bytes below and from the memory the
device reports (`memory_stats()["bytes_limit"]`).

The per-element figures are upper bounds, with about a quarter of
headroom, of `jax.jit(...).lower(...).compile().memory_analysis()` on an
NVIDIA H100 80GB HBM3 (700 W power limit): the solve's temporaries came
to 6.5-8.2 bytes per factory-matrix entry and byte of precision at
nreg/nstream = 2/4, 3/4, 2/8 and 3/8, in f32 and f64, at the shapes of
both CLI deployments of chip_smoke.py and of __graft_entry__'s compile
matrix, and to 16.4 at nreg/nstream = 1/2, where the terms that do not
grow with the matrix dominate; a whole run_radsurf program's arguments
and outputs to 44-93 bytes per element and byte of precision (PERF.md,
Findings).  chip_smoke.py holds both on every run: its compile phase
fails when an entry program's transients exceed solve_bytes_per_column,
its CLI phase when a run's peak device memory exceeds the budget these
figures give.
"""

from __future__ import annotations

# Transient bytes of one SW + LW solve per column x layer x band element,
# per byte of working precision and per entry of the factory matrix
# (N = 2 * nreg * nstream + nreg, so N**2 entries).
SOLVE_BYTES_PER_ENTRY = 10.0
# ... plus those that do not grow with the matrix (optical properties,
# region fractions, flux vectors): they dominate the smallest systems,
# 16.4 bytes per entry at N = 5 (nreg 1, 2 streams).
SOLVE_BYTES_PER_ELEMENT = 256.0
# Device-resident bytes of a whole run_radsurf program outside the solve's
# transients — gathered inputs, the four flux containers with profiles and
# their scatter copies — per column x layer x band element and per byte of
# working precision.
IO_BYTES_PER_ELEMENT = 120.0
# Shares of the device memory given to one solve chunk's transients and to
# one streamed slice's inputs and outputs; the rest is left to XLA's own
# buffers and the next slice in flight.
SOLVE_SHARE = 0.4
IO_SHARE = 0.2


def device_bytes_limit() -> int | None:
    """Memory one local device may allocate, or None where the backend
    reports no limit (the CPU)."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def solve_bytes_per_column(nreg: int, nstream: int, nlay: int, nband: int,
                           itemsize: int) -> int:
    """Transient bytes one column adds to a SW + LW solve."""
    n = 2 * nreg * nstream + nreg
    return int((SOLVE_BYTES_PER_ENTRY * n * n + SOLVE_BYTES_PER_ELEMENT)
               * nlay * nband * itemsize)


def io_bytes_per_column(nlay: int, nband: int, itemsize: int) -> int:
    """Device-resident input and output bytes one column adds to a run."""
    return int(IO_BYTES_PER_ELEMENT * nlay * nband * itemsize)


def even_chunk(n: int, max_chunk: int) -> int:
    """Chunk size for n items with at most max_chunk per chunk: 0 when all
    n fit, else the fewest chunks of near-equal size, preferring a chunk
    count that divides n so every chunk has the same shape (each distinct
    shape compiles its own executable)."""
    max_chunk = max(1, max_chunk)
    if n <= max_chunk:
        return 0
    n_min = -(-n // max_chunk)
    n_chunks = next(
        (k for k in range(n_min, min(2 * n_min, n) + 1) if n % k == 0),
        n_min,
    )
    return -(-n // n_chunks)
