"""Figure-of-merit measurement for the stratified tail splitting:
run the Mrk 421 flagship workload with
``strat_split`` off and on at the same seed/steps, and report the
relative MC error of the time-integrated flux per LC band plus the
variance-reduction figure of merit FOM = 1/(sigma_rel^2 * t_wall).

The stratified scheme is the unbiased vectorized replacement for the
reference's split2/spl3 in-flight splitting (imctrk2d.f:1-7,593-661,
726-736), whose stated purpose is exactly this: populate the rare
high-energy upscattering tail.

Run on the real chip:  python tools/strat_fom.py
Env: FOM_STEPS (default 12), FOM_NST (default 20000)
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def run(strat: bool, steps: int, nst: int, gamma_c: float = 1.0e3,
        copies: int = 1):
    import jax

    from compton2d_tpu.examples import mrk421, MRK421_BANDS, MRK421_GAMMA
    from compton2d_tpu.io.events import EventArrayStore

    # SSC-resolved density: at the canonical thin blob (n_e=20,
    # tau_T ~ 1e-7) essentially no Compton scatters occur at feasible
    # photon counts, so the splitting knob is vacuous there (the
    # round-3 FOM table's GeV/TeV rows on the thin config were the
    # degenerate-emission-CDF bug's garbage photons — see
    # artifacts/README.md). The dense variant (tau_T ~ 1e-2) gives the
    # tail stratum real events to split.
    sim = mrk421(nst=nst, n_slots=1 << 16, n_e=2.0e6)
    cfg = dataclasses.replace(
        sim.cfg,
        source=dataclasses.replace(
            sim.cfg.source, strat_split=strat, strat_gamma_c=gamma_c,
            strat_copies=copies,
        ),
    )
    sim = sim.with_config(cfg)
    store = EventArrayStore(sim.scales.E)
    sim.step()      # compile + bootstrap (excluded from timing)
    jax.block_until_ready(sim.state.photons.alive)
    t0 = time.time()
    for _ in range(steps):
        out = sim.step()
        store.write(out.events)
    jax.block_until_ready(sim.state.photons.alive)
    wall = time.time() - t0
    ev = store.all()

    from compton2d_tpu.io.postprocess import doppler_transform

    bands = np.asarray(MRK421_BANDS)
    res = []
    if len(ev):
        tr = doppler_transform(ev, MRK421_GAMMA, sim.cfg.grid.r_max)
        E, ew = tr[:, 1], tr[:, 2]
    else:
        E = ew = np.zeros((0,))
    for e0, e1 in bands:
        sel = (E >= e0) & (E < e1)
        f = float(ew[sel].sum())
        f2 = float((ew[sel] ** 2).sum())
        nrec = int(sel.sum())
        sig_rel = np.sqrt(f2) / f if f > 0 else float("inf")
        fom = (
            1.0 / (sig_rel**2 * wall)
            if np.isfinite(sig_rel) and sig_rel > 0
            else 0.0
        )
        res.append(
            dict(band_keV=[e0, e1], n=nrec, flux=f,
                 sigma_rel=sig_rel, fom=fom)
        )
    return wall, res


def main():
    steps = int(os.environ.get("FOM_STEPS", 12))
    nst = int(os.environ.get("FOM_NST", 20000))
    # three configurations: splitting off; the round-3 default
    # (gamma_c=1e3, one tail copy); and the TeV-targeted setting used
    # for the committed artifact (gamma_c=3e4, strat_copies=64 — the
    # split3-analogue multiplicity)
    w_off, r_off = run(False, steps, nst)
    w_on, r_on = run(True, steps, nst)
    w_tev, r_tev = run(True, steps, nst, gamma_c=3.0e4, copies=64)
    print(json.dumps({"strat": "off", "wall_s": round(w_off, 2)}))
    print(json.dumps({"strat": "on(gc=1e3,M=1)",
                      "wall_s": round(w_on, 2)}))
    print(json.dumps({"strat": "tev(gc=3e4,M=64)",
                      "wall_s": round(w_tev, 2)}))
    for a, b, c in zip(r_off, r_on, r_tev):
        def ratio(x):
            if a["fom"] > 0:
                return x["fom"] / a["fom"]
            return float("inf") if x["fom"] > 0 else 0.0
        print(json.dumps({
            "band_keV": a["band_keV"],
            "n_off": a["n"], "n_on": b["n"], "n_tev": c["n"],
            "sigma_rel_off": round(a["sigma_rel"], 4)
            if np.isfinite(a["sigma_rel"]) else None,
            "sigma_rel_on": round(b["sigma_rel"], 4)
            if np.isfinite(b["sigma_rel"]) else None,
            "sigma_rel_tev": round(c["sigma_rel"], 4)
            if np.isfinite(c["sigma_rel"]) else None,
            "fom_ratio_on_over_off": round(ratio(b), 3)
            if np.isfinite(ratio(b)) else None,
            "fom_ratio_tev_over_off": round(ratio(c), 3)
            if np.isfinite(ratio(c)) else None,
        }))


if __name__ == "__main__":
    main()
