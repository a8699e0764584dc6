"""End-to-end RAMI-V scene runs (test/rami5): 40-62 layer canopies, 14
spectral bands, 3 regions (2 vegetated), trees-as-urban trick
(trunks=buildings, test/rami5/README:4-8), spectral + profile outputs.

Marked slow; two representative configurations: diffuse illumination and
41-degree direct sun with black soil (the RAMI-V "bsoil" variant).
"""

import numpy as np
import pytest

from tests.test_reference_cases import read_out, run_driver

pytestmark = pytest.mark.slow

REF = "/root/reference/test/rami5"
SCENE = f"{REF}/scene_nc/rami5_HET07_JPS_SUM_scene.nc"


def spectral_residual(out, nlay_mask=True):
    """Per-column, per-band SW energy residual from the spectral outputs."""
    def lay_sum(name):
        v = out[name]
        return np.where(v == -9999.0, 0.0, v).sum(1)  # sum layers -> [C, B]

    r = out["ground_spectral_flux_net_sw"]
    for name in ("clear_air_spectral_absorption_sw",
                 "veg_spectral_absorption_sw",
                 "veg_air_spectral_absorption_sw",
                 "wall_spectral_flux_net_sw", "roof_spectral_flux_net_sw"):
        r = r + lay_sum(name)
    return r - out["top_spectral_flux_net_sw"]


@pytest.mark.parametrize("mode", ["diffuse", "direct41_blacksoil"])
def test_rami5_het07(tmp_path, mode):
    extra = "iverbose = 1,"
    if mode == "direct41_blacksoil":
        extra += ("\ntop_flux_dn_direct_sw = 1.0,"
                  "\nsolar_zenith_angle = 41,"
                  "\nground_sw_albedo = 0.0,")
    out_path = tmp_path / f"het07_{mode}.nc"
    run_driver(f"{REF}/config.nam", SCENE, out_path, extra_nam=extra,
               tmp_path=tmp_path)
    out = read_out(out_path)
    res = spectral_residual(out)
    # Residual per unit incoming flux; sub-threshold-region leakage allows
    # O(1e-6) (same semantics as the reference's frac_threshold zeroing)
    assert np.abs(res).max() < 5e-6
    # Canopy albedo per band physical and spectrally varying
    alb = 1.0 - (out["top_spectral_flux_net_sw"]
                 / out["top_spectral_flux_dn_sw"])
    assert np.all(alb > 0.0) and np.all(alb < 1.0)
    assert alb.max() - alb.min() > 0.05  # NIR brighter than VIS
    if mode == "direct41_blacksoil":
        # Black soil absorbs everything it receives
        np.testing.assert_allclose(
            out["ground_spectral_flux_net_sw"],
            out["ground_spectral_flux_dn_sw"], rtol=1e-9,
        )


# The reference's default target (test/rami5/Makefile:24-46): each scene
# under diffuse illumination plus its RAMI-V direct solar zenith angles,
# each with the real soil albedo and a black-soil variant.
SCENE_SZAS = {
    "HET07_JPS_SUM": (56, 41),
    "HET08_OPS_WIN": (76, 56),
    "HET09_JBS_SUM": (56, 41),
    "HET14_WCO_UND": (42, 60, 67),
    "HET15_JBS_WIN": (76, 56),
}


@pytest.mark.parametrize("scene", sorted(SCENE_SZAS))
def test_rami5_full_matrix(scene):
    """Every illumination x soil case of the reference's `make test` for
    one scene, solved in ONE batched run: the (diffuse + direct SZAs) x
    (real + black soil) matrix becomes the column axis — the batched
    equivalent of the reference's per-case driver invocations."""
    from spartacus_surface_tpu.driver.read_input import read_input
    from spartacus_surface_tpu.models import flux_utils
    from spartacus_surface_tpu.models.dispatch import run_radsurf
    from spartacus_surface_tpu.utils.config import Config, DriverConfig

    config = Config.from_namelist(f"{REF}/config.nam")
    config.do_save_flux_profile = False
    config.consolidate()
    dc = DriverConfig.from_namelist(f"{REF}/config.nam")
    data = read_input(f"{REF}/scene_nc/rami5_{scene}_scene.nc", config, dc)
    arrays = data["arrays"]

    szas = SCENE_SZAS[scene]
    n_illum = 1 + len(szas)            # diffuse + direct angles
    ncase = n_illum * 2                # x (real, black) soil
    arrays = {k: np.repeat(v, ncase, axis=0) for k, v in arrays.items()}
    cos_sza = np.ones(ncase)
    direct_frac = np.zeros(ncase)
    for i, sza in enumerate(szas):
        for soil in (0, 1):
            c = (1 + i) * 2 + soil
            cos_sza[c] = np.cos(np.deg2rad(sza))
            direct_frac[c] = 1.0
    arrays["cos_sza"] = cos_sza
    black = np.arange(ncase) % 2 == 1
    arrays["ground_albedo"][black] = 0.0
    arrays["ground_albedo_dir"][black] = 0.0

    out = run_radsurf(config, arrays)
    nsw = config.nswinternal
    top_dn = np.repeat(data["top_flux_dn_sw"], ncase, axis=0)
    dir_dn = top_dn * direct_frac[:, None]
    sw = flux_utils.sum_flux(
        flux_utils.scale_flux(out["sw_norm_dir"], dir_dn),
        flux_utils.scale_flux(out["sw_norm_diff"], top_dn - dir_dn),
    )
    res = flux_utils.check_flux(sw, arrays, "sw", printer=lambda *a: None)
    # Sub-threshold-region leakage over 62 layers allows O(1e-5) per unit
    # incoming (same frac_threshold semantics as the reference)
    np.testing.assert_allclose(res, 0.0, atol=2e-5 * np.max(top_dn.sum(-1)))
    # Black soil absorbs everything it receives
    np.testing.assert_allclose(
        sw["ground_net"][black], sw["ground_dn"][black], rtol=1e-9
    )
    # Real-soil scene albedo exceeds black-soil albedo at every band/case
    alb = 1.0 - sw["top_net"] / np.maximum(top_dn, 1e-30)
    assert np.all(alb[~black] >= alb[black] - 1e-12)
    assert np.all((alb > 0.0) & (alb < 1.0))
    # Direct-beam ground penetration decreases as the sun lowers
    direct_real = np.array([(1 + i) * 2 for i in range(len(szas))])
    pen = np.asarray(sw["ground_dn_dir"].sum(-1) / top_dn.sum(-1))[direct_real]
    order = np.argsort([np.cos(np.deg2rad(s)) for s in szas])
    for a, b in zip(order[:-1], order[1:]):  # ascending cos_sza
        assert pen[a] <= pen[b] + 1e-12
