"""Cross-section kernel tests: dilog identities, Thomson/KN limits,
agreement between the electron-averaged sigma_E and the closed-form KN
total cross section for cold electrons."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from compton2d_tpu.physics import compton


def test_dilog_neg_values():
    # Li2(-1) = -pi^2/12
    assert np.isclose(float(compton.dilog_neg(1.0)), -np.pi**2 / 12, rtol=1e-10)
    # Li2(0) = 0
    assert np.isclose(float(compton.dilog_neg(0.0)), 0.0, atol=1e-12)
    # series check at small argument: Li2(-x) ~ -x + x^2/4
    x = 1e-4
    assert np.isclose(
        float(compton.dilog_neg(x)), -x + x * x / 4, rtol=1e-8
    )
    # inversion branch: Li2(-10)
    # mpmath polylog(2, -10) = -4.1982778868581
    assert np.isclose(float(compton.dilog_neg(10.0)), -4.1982778868581, rtol=1e-10)


def test_kn_total_limits():
    # Thomson limit
    sig0 = float(compton.kn_total_sigma(1e-6))
    assert np.isclose(sig0, 6.65e-25, rtol=1e-4)
    # monotone decreasing
    E = jnp.array([1.0, 10.0, 100.0, 511.0, 5110.0])
    sig = np.asarray(compton.kn_total_sigma(E))
    assert np.all(np.diff(sig) < 0)
    # KN at x=1 (E=511 keV): sigma/sigT = 0.43068 (analytic)
    assert np.isclose(sig[3] / 6.65e-25, 0.43068, rtol=1e-3)


def test_sigma_e_cold_matches_kn_total():
    """For gamma -> 1 the angle-averaged sigma_E must reduce to the total
    KN cross section at the photon energy."""
    E = jnp.array([1.0, 10.0, 100.0, 511.0, 2000.0])
    gamma = 1.0 + 1e-6
    se = np.asarray(compton.sigma_e(E, gamma))
    kn = np.asarray(compton.kn_total_sigma(E))
    assert np.allclose(se, kn, rtol=2e-3)


def test_sigma_e_deep_kn_decline():
    """sigma_E must decline ~ln(x)/x in the deep KN regime for
    relativistic electrons."""
    g = 1.0e4
    se1 = float(compton.sigma_e(10.0, g))
    se2 = float(compton.sigma_e(100.0, g))
    assert se2 < se1 * 0.2


def test_zone_sigma_table_matmul_matches_loop():
    rng = np.random.default_rng(0)
    nE, ng, nz, nr = 16, 12, 3, 2
    E = np.geomspace(1e-3, 1e3, nE)
    gnt = np.geomspace(0.2, 1e4, ng)
    sig_tab = np.asarray(compton.sigma_e_table(jnp.asarray(E), jnp.asarray(gnt)))
    f_nt = rng.random((nz, nr, ng))
    n_e = rng.random((nz, nr)) * 1e10
    got = np.asarray(
        compton.zone_sigma_table(
            jnp.asarray(sig_tab), jnp.asarray(f_nt), jnp.asarray(gnt),
            jnp.asarray(n_e),
        )
    )
    dg = np.diff(gnt)
    w = np.concatenate([dg, [0.0]])
    want = np.einsum("zrg,eg->zre", f_nt * w, sig_tab) * n_e[..., None]
    want = np.maximum(want, 1e-40)
    assert np.allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# comp0 oracle: the reference's embedded cold Klein-Nishina table
# ---------------------------------------------------------------------------
_IMCDATE = "/root/reference/src/imcdate2d.f"

needs_imcdate = pytest.mark.skipif(
    not os.path.exists(_IMCDATE),
    reason="reference data tables (imcdate2d.f) not present",
)


def _load_comp0():
    """Parse the comp0(201) DATA statements from the reference's
    embedded Compton data tables (/root/reference/src/imcdate2d.f:97-167;
    axes documented at comtot2d.f:25-26: comp0(i) is the cold total
    Compton cross section [cm^2] at xnu = 5*(i-1) keV, i=1..201)."""
    import re

    vals = []
    with open(_IMCDATE) as fh:
        lines = fh.readlines()
    in_block = False
    for ln in lines:
        if re.match(r"\s*data \(comp0\(i\)", ln):
            in_block = True
            continue
        if in_block:
            nums = re.findall(r"([0-9]+\.[0-9]+)d([+-]?[0-9]+)", ln)
            vals.extend(float(m) * 10.0 ** int(e) for m, e in nums)
            if "/" in ln:
                in_block = False
    assert len(vals) == 201, len(vals)
    return np.array(vals)


@needs_imcdate
def test_kn_total_sigma_matches_comp0_oracle():
    """Golden test of the closed-form KN total cross section against the
    reference's own tabulated comp0 data (imcdate2d.f). The table was
    generated with sigma_T = 6.6516e-25 cm^2 (comp0(1) exactly) while
    the live nonthermal path in comtot2d.f:162 (and this module) uses
    6.65e-25; the comparison is therefore on the Thomson-normalized
    shape, plus a check that the overall scale ratio is exactly the
    sigma_T ratio."""
    comp0 = _load_comp0()
    E = 5.0 * np.arange(201)          # keV (comtot2d.f:26)
    kn = np.asarray(
        compton.kn_total_sigma(jnp.asarray(E, jnp.float64))
    ).astype(np.float64)
    # overall scale = table's sigma_T / module's sigma_T
    ratio = comp0 / kn
    scale = 6.6516e-25 / compton.SIGMA_T
    assert np.isclose(ratio[0], scale, rtol=1e-6)
    # shape agreement bin-by-bin at table precision; the last entry is
    # a duplicate of i=200 in the reference data (imcdate2d.f:166) so
    # it is excluded
    dev = np.abs(ratio[:-1] / scale - 1.0)
    assert dev.max() < 5e-5, dev.max()


@needs_imcdate
def test_sigma_e_cold_limit_matches_comp0_oracle():
    """sigma_e(E, gamma->1) bin-by-bin against comp0: the
    electron-averaged Coppi sigma_E must reduce to the cold KN total in
    the gamma->1 limit at every table energy."""
    comp0 = _load_comp0()
    E = 5.0 * np.arange(1, 200)       # skip E=0 (sigma_e needs x>0)
    se = np.asarray(
        compton.sigma_e(jnp.asarray(E, jnp.float64), 1.0 + 1e-8)
    ).astype(np.float64)
    scale = 6.6516e-25 / compton.SIGMA_T
    dev = np.abs(comp0[1:200] / (se * scale) - 1.0)
    assert dev.max() < 2e-3, dev.max()
