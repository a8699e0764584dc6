"""Tolerances of the production solver against pyref (float64).

Shared by tests/test_pyref_parity.py and chip_smoke.py's parity phase:
the production route (expm + doubling) and pyref's (the reference's eigen
route) differ in algorithm, so agreement is bounded by their measured
divergence, not by machine epsilon.
"""

# Fields where the normalized magnitudes are O(1); atol guards fields that
# pass through near-cancelling differences (net fluxes, absorption).  The
# absolute floor is set by the measured eigen-vs-doubling route divergence
# on PHYSICALLY-ZERO quantities (clear-air absorption of nearly-empty
# layers lands at ~2e-7 per unit TOC with either route; the rami5 audit's
# worst absolute error is 1.6e-7 — tools/derive_rami5_tolerances.py), so
# 5e-7 distinguishes "both routes say zero" from a real defect.
RTOL = 1e-5
ATOL = 5e-7


# Per-field tolerances for the rami5 suite, derived from the measured
# worst relative error (over elements with |oracle| > 1e-6) across ALL
# FIVE scenes — eigen-route (pyref) vs expm+doubling (production) in f64
# over 62 layers.  Default is the global RTOL = 1e-5; route-divergence
# slack is granted only where the doubling-vs-eigen difference actually
# lives, each with ~2x headroom over its observed error:
#   field                observed     granted
#   wall_in / wall_net    8.6e-5       2e-4
#   veg_abs               6.4e-5       1.5e-4
#   flux_up_layer_top     2.8e-5       6e-5
#   sw_albedo_dir         2.8e-5       6e-5
#   flux_up_layer_base    1.4e-5       3e-5
# Worst ABSOLUTE error anywhere: 1.6e-7 (atol=1e-6 covers near-zero
# elements).  Regenerate/audit the table with
# tools/derive_rami5_tolerances.py, which recomputes the per-field maxima
# and verifies they reproduce this dict.
RAMI5_RTOL_FIELDS = {
    "wall_in": 2e-4,
    "wall_net": 2e-4,
    "veg_abs": 1.5e-4,
    "flux_up_layer_top": 6e-5,
    "flux_up_layer_base": 3e-5,
    "sw_albedo_dir": 6e-5,
}
