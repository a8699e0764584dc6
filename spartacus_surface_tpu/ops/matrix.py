"""Batched small-matrix algebra for the SPARTACUS layer operators.

Replacement for the reference's hand-written batched matrix library
(radtool/radtool_matrix.F90).  All operations act on arrays shaped
[..., n, m] with arbitrary leading batch dimensions (the reference instead
carries the batch innermost for CPU SIMD, radtool_matrix.F90:20-24; here
the batch leads and XLA spreads it over the device).

Solves go to jnp.linalg.solve (partial-pivoting LU) on every backend, so
the CPU tests exercise the route the GPU runs.  The reference's own LU is
pivot-free (radtool_matrix.F90:982-1015; the SPARTACUS matrices are
diagonally dominant), and pivoting only ever improves accuracy.  An
unrolled pivot-free elimination was the earlier route; on an NVIDIA H100
it ran slower at every size the solver uses and compiled 20-120x slower
(PERF.md, "solve route").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matmul(a, b):
    """Batched matrix product: [..., n, k] @ [..., k, m]."""
    return jnp.matmul(a, b, precision="highest")


def matvec(a, x):
    """Batched matrix-vector product: [..., n, k] @ [..., k]."""
    return jnp.einsum("...nk,...k->...n", a, x, precision="highest")


@jax.jit
def solve(a, b):
    """Batched solve a @ x = b.

    a: [..., n, n]; b: [..., n, m] (matrix RHS) or [..., n] (vector RHS).
    Orders 1 and 2 are solved in closed form, larger ones by
    jnp.linalg.solve (see the module docstring).
    Parity: solve_mat/solve_vec dispatchers radtool/radtool_matrix.F90:1119-1199.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    vector = b.ndim == a.ndim - 1
    if vector:
        b = b[..., None]
    if a.shape[-1] == 1:
        x = b / a[..., :, :1]
    elif a.shape[-1] == 2:
        x = _solve2(a, b)
    else:
        x = jnp.linalg.solve(a, b)
    return x[..., 0] if vector else x


def _solve2(a, b):
    """Cramer 2x2 solve (parity: radtool_matrix.F90:779-825)."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = (1.0 / det)[..., None]
    x0 = (a[..., 1, 1][..., None] * b[..., 0, :] - a[..., 0, 1][..., None] * b[..., 1, :])
    x1 = (a[..., 0, 0][..., None] * b[..., 1, :] - a[..., 1, 0][..., None] * b[..., 0, :])
    return jnp.stack([x0 * inv_det, x1 * inv_det], axis=-2)


def inv(a):
    """Batched inverse via solve (radtool_matrix.F90:1057-1116)."""
    a = jnp.asarray(a)
    n = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    return solve(a, eye)


# Pade-7 numerator coefficients (as in the diagonal Pade approximant used for
# scaling-and-squaring matrix exponentials; cf. the reference's Pade-7 expm at
# radtool/radtool_matrix.F90:1246-1344).  Valid to machine precision for
# ||A|| <~ 0.95; the layer kernel pre-scales far below that.
_PADE7_B = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0)


@jax.jit
def expm_pade7(a):
    """Batched matrix exponential, diagonal Pade [7/7], NO scaling/squaring.

    The caller must pre-scale so that ||a|| is small (the layer kernel scales
    by dz * 2**-n_double).  Cost: 4 matmuls + 1 multi-RHS solve.
    """
    a = jnp.asarray(a)
    b = _PADE7_B
    n = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    a2 = matmul(a, a)
    a4 = matmul(a2, a2)
    a6 = matmul(a2, a4)
    u = matmul(a, b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye)
    v = b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye
    return solve(v - u, v + u)
