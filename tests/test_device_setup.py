"""Device-side setup that runs before any solve: the memory-derived batch
sizes (utils/memory.py), one card per process (parallel/distributed.py),
the compile-cache directory (utils/compile_cache.py) and the multi-device
dry run's device choice (__graft_entry__.py)."""

import os
import subprocess

import jax
import pytest

from spartacus_surface_tpu.parallel import distributed
from spartacus_surface_tpu.utils import compile_cache, memory

GIB = 2**30


@pytest.mark.parametrize("n,max_chunk,want", [
    (100, 100, 0),      # fits: no chunking
    (100, 1000, 0),
    (100, 50, 50),      # two even chunks
    (100, 40, 25),      # 4 equal chunks beat 3 unequal ones
    (97, 10, 10),       # prime: the fewest ceil-split chunks
    (50048, 20000, 12512),
    (10, 0, 1),         # a zero budget still makes progress
])
def test_even_chunk(n, max_chunk, want):
    got = memory.even_chunk(n, max_chunk)
    assert got == want
    if got:
        assert got <= max(1, max_chunk)


def test_solve_bytes_scale_with_system_and_batch():
    base = memory.solve_bytes_per_column(2, 4, 8, 1, 4)
    n = 2 * 2 * 4 + 2
    assert base == int((memory.SOLVE_BYTES_PER_ENTRY * n * n
                        + memory.SOLVE_BYTES_PER_ELEMENT) * 8 * 4)
    assert memory.solve_bytes_per_column(2, 4, 16, 1, 4) == 2 * base
    assert memory.solve_bytes_per_column(2, 4, 8, 14, 4) == 14 * base
    assert memory.solve_bytes_per_column(2, 4, 8, 1, 8) == 2 * base
    assert memory.solve_bytes_per_column(3, 4, 8, 1, 4) > base
    assert memory.io_bytes_per_column(62, 14, 4) == int(
        memory.IO_BYTES_PER_ELEMENT * 62 * 14 * 4)


def test_cpu_reports_no_limit():
    assert memory.device_bytes_limit() is None


@pytest.mark.parametrize("limit_gib", [60, 15])
def test_auto_column_chunk_from_memory(monkeypatch, limit_gib):
    """AUTO column_chunk = the fewest even chunks whose solve working set
    fits SOLVE_SHARE of the device limit."""
    from spartacus_surface_tpu.models.solver import (SolverOptions,
                                                     _resolve_column_chunk)
    from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss

    monkeypatch.setattr(memory, "device_bytes_limit",
                        lambda: limit_gib * GIB)
    lg = LegendreGauss(4)
    opt = SolverOptions(nreg=3, nstream=4, do_urban=True, column_chunk=-1)
    per_col = memory.solve_bytes_per_column(3, 4, 62, 14, 4)
    max_cols = int(memory.SOLVE_SHARE * limit_gib * GIB) // per_col
    ck = _resolve_column_chunk(opt, lg, 50048, 62, 14, 4)
    assert ck == memory.even_chunk(50048, max_cols)
    assert 0 < ck <= max_cols
    # A batch that fits is not chunked; explicit sizes pass through
    assert _resolve_column_chunk(opt, lg, max_cols, 62, 14, 4) == 0
    explicit = SolverOptions(nreg=3, nstream=4, do_urban=True,
                             column_chunk=512)
    assert _resolve_column_chunk(explicit, lg, 50048, 62, 14, 4) == 512


@pytest.mark.parametrize("process_id,num_processes,n_local,want", [
    (0, 1, 4, None),        # one process: JAX's own default
    (0, 4, 4, [0]),
    (3, 4, 4, [3]),
    (5, 8, 4, [1]),         # second host of two, contiguous ranks
    (1, 2, 0, None),        # no GPUs: CPU processes bind nothing
    (None, 2, 4, None),     # rank left to a cluster launcher
])
def test_local_device_ids(process_id, num_processes, n_local, want):
    assert distributed.local_device_ids(
        process_id, num_processes, n_local) == want


def test_count_local_gpus(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2, 3")
    assert distributed.count_local_gpus() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert distributed.count_local_gpus() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")

    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", no_smi)
    assert distributed.count_local_gpus() == 0


def test_initialize_binds_one_card(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(distributed, "count_local_gpus", lambda: 4)
    distributed.initialize("localhost:1234", num_processes=4, process_id=2)
    assert seen["local_device_ids"] == [2]
    assert seen["coordinator_address"] == "localhost:1234"
    seen.clear()
    distributed.initialize(None, num_processes=1, process_id=0)
    assert seen == {}


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_checkout_dir():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(compile_cache.CACHE_DIR) == repo
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(compile_cache.CACHE_DIR) + "/" in ignored


def test_dryrun_multichip_uses_own_devices():
    """The dry run never switches platforms: it runs on the process's
    devices, and refuses a mesh larger than them."""
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        g.dryrun_multichip(64)
    assert jax.devices()[0].platform == "cpu"
