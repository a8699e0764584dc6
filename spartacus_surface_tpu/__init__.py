"""spartacus_surface_tpu: a JAX SPARTACUS-Surface canopy radiation framework.

A brand-new JAX/XLA implementation of the capabilities of ECMWF's
SPARTACUS-Surface scheme (reference: Fortran-2003, ecmwf/spartacus-surface): 3-D
shortwave and longwave radiative transfer in forest and urban canopies
described statistically, using a multi-layer, multi-region, multi-stream
discrete-ordinate formulation.

Design (re-derived for accelerators, not a port):
  * The reference's per-layer eigen-decomposition machinery
    (radtool/radtool_calc_matrices_sw_eig.F90, radtool_eigen_decomposition.F90)
    is replaced by a branch-free matrix-exponential + adding-method-doubling
    kernel built entirely from batched small-matrix multiplies and LU
    solves (ops/layer_matrices.py), batched over columns x layers x
    spectral intervals.
  * Ragged packed columns (radsurf/radsurf_canopy_properties.F90:43-59) become
    dense padded tensors with dz=0 padding layers (expm(0)=I makes padding an
    exact no-op).
  * Columns are embarrassingly parallel
    (driver/spartacus_surface_driver.F90:199-234 uses OpenMP); here the column
    axis is sharded over a jax.sharding Mesh (parallel/mesh.py).
"""

__version__ = "0.1.0"
