"""Run the Mrk 421 SSC flare flagship workload to completion and write
the science artifact.

The reference's de-facto acceptance test is the Mrk 421 workflow
(README.how_to_run_the_code + postprocessing/mrk421_lc.input: Gamma=33,
r_max = 2.5e15 cm blob, dt = 700 s observed bands, 7 energy bands from
optical to TeV, compared against data/observations/). This script:

1. runs ``examples.mrk421`` to t_stop = 7e4 s (comoving) with outputs
   attached (event records in the reference 7-column format);
2. post-processes the escaping-photon events with the native
   plcm/pspt reimplementation (io/postprocess): Doppler-boosted 7-band
   light curves at the reference's 700-s observed cadence and the
   time-integrated SED;
3. writes ``artifacts/mrk421/``: sed.dat (E, nuFnu, counts),
   lc.dat (t, 7 band rates), summary.json (peak locations, fluxes,
   run metadata). tests/test_mrk421.py asserts the committed
   artifact's SED peaks land in the right decades (synchrotron ~keV
   and below, SSC in the GeV decades for these parameters).

Usage (the committed artifacts):
  canonical: python tools/run_mrk421.py --nst 200000 --n-slots 131072 \
                 --strat-copies 8 --out artifacts/mrk421
  dense/TeV: python tools/run_mrk421.py --nst 200000 --n-slots 131072 \
                 --n-e 2e6 --strat-gamma-c 3e4 --strat-copies 64 \
                 --out artifacts/mrk421_dense
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

GAMMA_BULK = 33.0          # postprocessing/mrk421_lc.input:2
T_BIN_OBS = 700.0          # observed-frame cadence [s] (:13)
MU_RANGE = (0.99944, 0.99964)  # observer cone (:5-6 pattern)
# Mrk 421: z = 0.031, d_L ~ 134 Mpc (H0 = 71)
D_L_CM = 4.14e26


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nst", type=int, default=60000)
    ap.add_argument("--n-slots", type=int, default=1 << 17)
    ap.add_argument("--out", default="artifacts/mrk421")
    ap.add_argument("--t-stop", type=float, default=7.0e4)
    # stratified tail splitting ON by default: the blob is optically
    # thin (tau_T ~ 1e-7), so un-split SSC scatters are ~1-in-1e7
    # events and the GeV-TeV bands would be empty at any feasible nst —
    # the reason the reference's production inputs set split2/split3
    # (imctrk2d.f:726-736) and this framework has strat_split
    # (tools/strat_fom.py measures its figure of merit)
    ap.add_argument("--no-strat", dest="strat", action="store_false",
                    default=True)
    # tail-stratum boundary: gamma_c ~ 3e4 targets the TeV band
    # (observed 1e9 keV needs comoving E ~ 1e9/D ~ 3e7 keV, i.e. the
    # KN limit of gamma ~ 6e4 electrons)
    ap.add_argument("--strat-gamma-c", type=float, default=1.0e3)
    # tail copies per scatter (split3 analogue): >1 multiplies deep-KN
    # statistics on the optically thin blob where scatters are rare
    ap.add_argument("--strat-copies", type=int, default=1)
    ap.add_argument("--n-e", type=float, default=20.0)
    args = ap.parse_args()

    import dataclasses

    from compton2d_tpu import runtime
    from compton2d_tpu.examples import MRK421_BANDS, mrk421
    from compton2d_tpu.io import postprocess as pp

    print(f"# compile cache: {runtime.enable_compile_cache()}")

    os.makedirs(args.out, exist_ok=True)
    sim = mrk421(nst=args.nst, n_slots=args.n_slots, n_e=args.n_e)
    cfg = dataclasses.replace(
        sim.cfg,
        run=dataclasses.replace(sim.cfg.run, t_stop=args.t_stop),
        source=dataclasses.replace(
            sim.cfg.source, strat_split=args.strat,
            strat_gamma_c=args.strat_gamma_c,
            strat_copies=args.strat_copies,
        ),
    )
    sim = sim.with_config(cfg)
    sim.attach_outputs(args.out, event_file="evb.dat")

    t0 = time.time()
    done = sim.run_to_stop(verbose=True)
    wall = time.time() - t0
    audit = sim.energy_audit()
    print(f"# completed={done} steps={int(sim.state.ncycle)} "
          f"wall={wall:.1f}s balance={audit['balance']:.6f}")

    # ---- post-process the event records -------------------------------
    # NOTE on r_max: the TOF transform uses the GRID's own blob radius
    # (2.5e15 cm, examples.py) for geometric self-consistency. The
    # reference's postprocessing template pins rmax = 1e16 cm
    # (postprocessing/mrk421_lc.input:3) — that value describes ITS
    # (unshipped) simulation geometry, not a physics constraint; our
    # R = 2.5e15 cm blob gives an observed variability time
    # R/(c*D) ~ 2.5e3 s, the rapid X-ray/TeV variability Mrk 421 is
    # known for. Both radii only enter the light-travel alignment of
    # the light curves.
    ev_path = os.path.join(args.out, "evb.dat")
    events = np.loadtxt(ev_path)
    if events.ndim == 1:
        events = events[None, :]
    print(f"# {len(events)} escaping-photon records")
    r_max = sim.cfg.grid.r_max

    # SED: full run, log grid over the Doppler-boosted range.
    # evb.dat weights are already in erg (EventFileWriter applies
    # energy_scale on write). Absolute normalization follows pspt.c's
    # convention (F /= dt*dE*(mu1-mu0)/2, i.e. isotropic-equivalent
    # luminosity) over the observed duration actually covered, then
    # nuFnu at Earth = E * L_E / (4 pi d_L^2).
    e_edges = np.geomspace(1e-8, 1e11, 150)
    tr = pp.doppler_transform(events, GAMMA_BULK, r_max)
    t_obs_all = tr[:, 0]
    t_span = float(np.percentile(t_obs_all, 99.5)) or 1.0
    s = pp.sed(events, GAMMA_BULK, r_max, 0.0, t_span, e_edges,
               mu_range=MU_RANGE)
    e_mid = np.sqrt(e_edges[1:] * e_edges[:-1])
    de = np.diff(e_edges)
    dmu_half = 0.5 * (MU_RANGE[1] - MU_RANGE[0])
    # isotropic-equivalent L_E [erg/s/keV] (pspt.c:318-321)
    l_e = s.flux / (t_span * de * dmu_half)
    nufnu_earth = e_mid * l_e / (4.0 * np.pi * D_L_CM**2)
    nufnu = e_mid * s.flux / de   # shape-only column (legacy)
    np.savetxt(
        os.path.join(args.out, "sed.dat"),
        np.column_stack([e_mid, nufnu, s.counts, nufnu_earth]),
        header=(
            "E_obs[keV]  E*F(E)[erg, shape]  n_records  "
            f"nuFnu_earth[erg/cm^2/s @ d_L={D_L_CM:.3e}cm, "
            f"mu={MU_RANGE[0]}..{MU_RANGE[1]}]"
        ),
        fmt="%14.6e",
    )

    # light curves at the reference cadence
    t_hi = np.percentile(t_obs_all, 99.5)
    t_edges = np.arange(0.0, t_hi + T_BIN_OBS, T_BIN_OBS)
    lc = pp.light_curves(
        events, GAMMA_BULK, r_max, t_edges,
        np.asarray(MRK421_BANDS),
    )
    rate = lc.rate().sum(axis=1)   # erg/s, summed over mu bins
    hdr = "t_mid[s] " + " ".join(
        f"band{b}[{lo:g}-{hi:g}keV]"
        for b, (lo, hi) in enumerate(MRK421_BANDS)
    )
    t_mid = 0.5 * (t_edges[1:] + t_edges[:-1])
    np.savetxt(
        os.path.join(args.out, "lc.dat"),
        np.column_stack([t_mid, rate]), header=hdr, fmt="%14.6e",
    )

    # ---- peak summary -------------------------------------------------
    # split the SED at 1 MeV: synchrotron peak below, SSC peak above
    lo_m = (e_mid < 1e3) & (nufnu > 0)
    hi_m = (e_mid >= 1e3) & (nufnu > 0)
    sync_peak = float(e_mid[lo_m][np.argmax(nufnu[lo_m])]) if lo_m.any() else None
    ssc_peak = float(e_mid[hi_m][np.argmax(nufnu[hi_m])]) if hi_m.any() else None
    tev = (e_mid >= 1e9) & (e_mid < 1e10)
    tev_flux = float(nufnu[tev].sum())
    tev_records = int(s.counts[tev].sum())
    tev_earth = float(np.max(nufnu_earth[tev])) if tev.any() else 0.0
    # all-angle TeV statistics (the observer cone is only ~11% of the
    # comoving sphere; the all-mu count is the robust record statistic)
    e_all = tr[:, 1]
    tev_all = int(np.sum((e_all >= 1e9) & (e_all < 1e10)))
    gev100_all = int(np.sum(e_all >= 1e8))
    summary = {
        "gamma_bulk": GAMMA_BULK,
        "t_stop_comoving_s": args.t_stop,
        "nst": args.nst,
        "steps": int(sim.state.ncycle),
        "n_event_records": int(len(events)),
        "balance": float(audit["balance"]),
        "sync_peak_keV_obs": sync_peak,
        "ssc_peak_keV_obs": ssc_peak,
        "tev_band_nufnu": tev_flux,
        "tev_band_records": tev_records,
        "tev_band_records_all_mu": tev_all,
        "gev100_records_all_mu": gev100_all,
        "tev_band_nufnu_earth": tev_earth,
        "strat_gamma_c": args.strat_gamma_c,
        "strat_copies": args.strat_copies,
        "sync_peak_nufnu_earth": float(
            np.max(nufnu_earth[lo_m]) if lo_m.any() else 0.0
        ),
        "mu_range": list(MU_RANGE),
        "d_l_cm": D_L_CM,
        "wall_s": round(wall, 1),
        "backend": __import__("jax").default_backend(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
