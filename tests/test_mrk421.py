"""Mrk 421 workload smoke test: shock-injected SSC blob produces
synchrotron + IC photons; Doppler post-processing in the reference's
mu window yields band light curves."""
import numpy as np
import pytest

from compton2d_tpu import examples
from compton2d_tpu.io import events as ev
from compton2d_tpu.io import postprocess as pp


def test_mrk421_small_run():
    # num_nt=160 so the gamma grid reaches past the injection band
    # (g1=5e2, g2=2e5); smaller grids leave injection inert
    sim = examples.mrk421(
        nz=4, nr=2, nst=1500, n_slots=8192, num_nt=160, n_vol=64,
        nphfield=64,
    )
    store = ev.EventArrayStore(sim.scales.E)
    for _ in range(4):
        out = sim.step()
        store.write(out.events)
        a = sim.energy_audit()
        assert np.isclose(a["balance"], 1.0, atol=5e-3), a
    evts = store.all()
    assert evts.shape[0] > 0
    # Doppler post-processing with the reference workload parameters
    lc = pp.light_curves(
        evts, examples.MRK421_GAMMA, sim.cfg.grid.r_max,
        t_edges=np.arange(0.0, 8 * examples.MRK421_DT_S,
                          examples.MRK421_DT_S),
        e_bands=np.asarray(examples.MRK421_BANDS),
        mu_edges=np.array([examples.MRK421_MU_RANGE[0],
                           examples.MRK421_MU_RANGE[1]]),
    )
    assert np.all(np.isfinite(lc.flux))
    # the shock injects nonthermal electrons -> synchrotron photons
    # escape; total flux across all bands/angles must be positive
    sed = pp.sed(
        evts, examples.MRK421_GAMMA, sim.cfg.grid.r_max,
        0.0, 1e9, np.geomspace(1e-8, 1e10, 60),
    )
    assert sed.flux.sum() > 0


def test_mrk421_committed_artifact_sanity():
    """The committed flagship science artifacts (artifacts/mrk421*,
    produced by tools/run_mrk421.py on the chip — the de-facto
    acceptance test the reference ran against data/observations/,
    SURVEY.md par.4) must have their SED peaks in the right decades:

    - thin canonical blob: observed synchrotron peak in the 0.05-50 keV
      band (Mrk 421's sync peak is ~0.1-1 keV);
    - dense SSC-resolved variant: an inverse-Compton branch peaking
      above 1 GeV observed, positive flux above 10 MeV, AND a
      populated TeV band — positive nuFnu in the reference's band 7
      (1e9-1e10 keV observed, postprocessing/mrk421_lc.input) with
      >= 20 TeV-band event records over all angles (produced with
      strat_gamma_c = 3e4 + strat_copies = 64, the
      split3-analogue tail multiplicity).
    """
    import json
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "artifacts")
    with open(os.path.join(root, "mrk421", "summary.json")) as fh:
        thin = json.load(fh)
    assert thin["balance"] == pytest.approx(1.0, abs=5e-3)
    assert 0.05 < thin["sync_peak_keV_obs"] < 50.0
    assert thin["n_event_records"] > 10_000

    with open(os.path.join(root, "mrk421_dense", "summary.json")) as fh:
        dense = json.load(fh)
    assert dense["balance"] == pytest.approx(1.0, abs=5e-3)
    assert dense["ssc_peak_keV_obs"] is not None
    assert dense["ssc_peak_keV_obs"] > 1.0e6       # above 1 GeV observed
    # TeV band populated (band 7 of the reference workload)
    assert dense["tev_band_nufnu"] > 0.0
    assert dense["tev_band_nufnu_earth"] > 0.0
    assert dense["tev_band_records_all_mu"] >= 20
    sed = np.loadtxt(os.path.join(root, "mrk421_dense", "sed.dat"))
    e_mid, nufnu = sed[:, 0], sed[:, 1]
    assert nufnu[(e_mid > 1.0e4)].sum() > 0.0       # flux above 10 MeV
    # both branches present: a low-energy peak below 1 MeV too
    assert nufnu[(e_mid < 1.0e3)].max() > 0.0


def test_mrk421_obs_compare_artifact():
    """The committed observational comparison (tools/obs_compare.py
    against /root/reference/data/observations — the reference's
    de-facto acceptance data, SURVEY.md par.4) must be internally
    consistent and record the quantitative statements this framework
    actually achieves:

    - the canonical blob's observed synchrotron peak falls in the
      decade the loaded Mrk 421 X-ray data constrain (0.01-10 keV);
    - the absolute X-ray nuFnu level matches the observations up to
      the ONE recorded global renormalization (a blob filling/activity
      factor): |log10 model/obs| <= 2.5 dex for both committed
      variants, with the applied renorm recorded in the artifact.
    """
    import json
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "artifacts")
    for variant in ("mrk421", "mrk421_dense"):
        path = os.path.join(root, variant, "obs_compare.json")
        with open(path) as fh:
            oc = json.load(fh)
        assert oc["sync_peak_in_obs_decade"] is True, (variant, oc)
        med = oc["xray_log10_model_over_obs_median"]
        assert med is not None and abs(med) <= 2.5, (variant, med)
        assert oc["global_renorm_log10"] == pytest.approx(-med)
        # the overlay table exists and mixes model + observed rows
        dat = os.path.join(root, variant, "obs_compare.dat")
        with open(dat) as fh:
            lines = fh.readlines()
        assert any(" 0 model" in ln for ln in lines)
        assert any(" 1 " in ln and "model" not in ln for ln in lines)
