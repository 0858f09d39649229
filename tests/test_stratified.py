"""Stratified tail splitting: the weighted (rejection-free) scatter
sampler must be unbiased against the acceptance-rejection sampler, the
stratum combination must reproduce the full estimator, and end-to-end
splitting must populate the deep-KN tail at an exact energy audit.

This is the vectorized replacement for the reference's split2/spl3
in-flight splitting (imctrk2d.f:593-661) whose resample-until-big loop
is biased; the stratified scheme is unbiased by construction."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu.physics import electron_dist as ed
from compton2d_tpu.physics.compton import SIGMA_T, zone_sigma_table
from compton2d_tpu.tables import e_field_grid
from compton2d_tpu.transport.scatter import scatter, scatter_stratified


def _hybrid_cdf(num_nt=80, tea=50.0, amxwl=0.9, gmin=1e2, gmax=1e4,
                p_nth=2.4):
    gnt = jnp.asarray(ed.gnt_grid(num_nt))
    shape = lambda v: jnp.full((1, 1), v, jnp.float32)
    f_nt = ed.init_f_nt(gnt, shape(tea), shape(amxwl), shape(gmin),
                        shape(gmax), shape(p_nth))
    cdf = ed.build_cdf(f_nt, gnt)
    return gnt, f_nt, cdf


def _moments(n=200_000, e_kev=10.0, seed=0):
    gnt, f_nt, cdf = _hybrid_cdf()
    e = jnp.full((n,), e_kev, jnp.float32)
    mu = jnp.full((n,), 0.3, jnp.float32)
    cphi = jnp.ones((n,), jnp.float32)
    sphi = jnp.zeros((n,), jnp.float32)
    rows = jnp.broadcast_to(cdf.reshape(1, -1), (n, cdf.shape[-1]))
    k = jax.random.PRNGKey(seed)
    res_rej = scatter(k, e, mu, cphi, sphi, rows, gnt)
    res_w = scatter_stratified(
        jax.random.fold_in(k, 1), e, mu, cphi, sphi, rows, gnt,
        u_lo=jnp.zeros((n,), jnp.float32),
        u_hi=jnp.ones((n,), jnp.float32),
        inv_z=jnp.ones((n,), jnp.float32),
    )
    return gnt, f_nt, cdf, e, res_rej, res_w


def test_weighted_sampler_matches_rejection_sampler():
    """Self-normalized weighted estimator E[xknot*(e'/e)]/E[xknot]
    equals the rejection sampler's mean weight scale."""
    gnt, f_nt, cdf, e, res_rej, res_w = _moments()
    # res_w.wscale = (e'/e) * xknot  (inv_z = 1); xknot = wscale*e/e'
    xknot = res_w.wscale * e / jnp.maximum(res_w.e, 1e-30)
    m_w = float(jnp.sum(res_w.wscale) / jnp.sum(xknot))
    m_rej = float(jnp.mean(res_rej.wscale))
    assert np.isclose(m_w, m_rej, rtol=2e-2), (m_w, m_rej)


def test_normalizer_matches_sigma_table():
    """The empirical <xknot> under the (f, flux) measure equals
    sigma_zone(E) / (n_e sigma_T F_tot) — the inv_nsigt normalizer the
    driver feeds the tracker."""
    gnt, f_nt, cdf, e, _, res_w = _moments(n=400_000)
    xknot = res_w.wscale * e / jnp.maximum(res_w.e, 1e-30)
    z_emp = float(jnp.mean(xknot))
    e_grid = e_field_grid(64)
    from compton2d_tpu.physics.compton import sigma_e_table

    sig_tab = jnp.asarray(
        sigma_e_table(e_grid, np.asarray(gnt)), jnp.float32
    )
    sig = zone_sigma_table(
        sig_tab, f_nt.reshape(1, 1, -1), gnt, jnp.ones((1, 1))
    )[0, 0]
    # interpolate at e_kev = 10
    i = int(np.searchsorted(e_grid, 10.0)) - 1
    f = (np.log(10.0) - np.log(e_grid[i])) / (
        np.log(e_grid[i + 1]) - np.log(e_grid[i])
    )
    sig_e = float(sig[i]) * (1 - f) + float(sig[i + 1]) * f
    ftot = float(jnp.sum(f_nt[0, 0, :-1] * jnp.diff(gnt)))
    z_tab = sig_e / (SIGMA_T * ftot)
    assert np.isclose(z_emp, z_tab, rtol=3e-2), (z_emp, z_tab)


def test_stratified_combination_unbiased():
    """(1-p) * E_A[wscale] + p * E_B[wscale] == E_full[wscale]."""
    n = 400_000
    # the 80-bin grid spans gamma-1 in [0.18, 337]: keep the hybrid
    # tail and the stratum cut well inside it
    gnt, f_nt, cdf = _hybrid_cdf(gmin=50.0, gmax=300.0)
    icut = int(np.searchsorted(np.asarray(ed.gnt_grid(80)), 150.0 - 1.0))
    c = float(cdf[0, 0, icut])
    p = 1.0 - c
    assert 1e-4 < p < 0.5

    e = jnp.full((n,), 10.0, jnp.float32)
    mu = jnp.full((n,), -0.2, jnp.float32)
    cphi = jnp.ones((n,), jnp.float32)
    sphi = jnp.zeros((n,), jnp.float32)
    rows = jnp.broadcast_to(cdf.reshape(1, -1), (n, cdf.shape[-1]))
    k = jax.random.PRNGKey(7)
    ones = jnp.ones((n,), jnp.float32)

    def mean_wscale(u_lo, u_hi, kk):
        r = scatter_stratified(
            kk, e, mu, cphi, sphi, rows, gnt,
            u_lo=u_lo * ones, u_hi=u_hi * ones, inv_z=ones,
        )
        return float(jnp.mean(r.wscale))

    m_full = mean_wscale(0.0, 1.0, k)
    m_a = mean_wscale(0.0, c, jax.random.fold_in(k, 1))
    m_b = mean_wscale(c, 1.0, jax.random.fold_in(k, 2))
    m_comb = (1.0 - p) * m_a + p * m_b
    # the full estimator is tail-dominated and noisy; the combined one
    # is the variance-reduced version of the same expectation
    assert np.isclose(m_comb, m_full, rtol=0.15), (m_comb, m_full)
    # the B stratum really is the high-gamma tail: much larger
    # amplification than the sub-cut stratum
    assert m_b > 10.0 * m_a


def test_end_to_end_tail_coverage():
    """Optically-thick corona with a rare (p ~ 1e-3) nonthermal tail:
    stratified splitting multiplies the number of distinct deep-KN tail
    photon samples at fixed nst, with the audit exact."""
    from compton2d_tpu.config import (
        GridConfig, PhysicsConfig, RunConfig, SimConfig, SourceConfig,
        TimeWindow, ZoneInit,
    )
    from compton2d_tpu.driver import Simulation

    nz, nr = 2, 2
    grid = GridConfig(
        nz=nz, nr=nr, z_max=1e15, r_max=1e15,
        num_nt=120, n_vol=48, nphfield=48, n_gg=16, n_ref=50, nmu=4,
        spectral_regions=((1e-4, 1e-1, 10), (1e-1, 1e7, 30)),
        lc_bands=((2.0, 10.0),),
    )
    win = TimeWindow(
        t0=0.0, t1=1e30, tbb_lower=(0.5,) * nr, tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz, tbb_outer=(0.0,) * nz,
    )

    def run(strat):
        cfg = SimConfig(
            grid=grid, physics=PhysicsConfig(t_const=True),
            source=SourceConfig(
                nst=1000, strat_split=strat, strat_gamma_c=1e3,
            ),
            run=RunConfig(seed=0, n_slots=16384, event_capacity=16384,
                          max_flight_iters=256),
            windows=(win,),
        )
        # tau ~ 6, 99.9% thermal at 50 keV + 0.1% power-law tail
        zi = ZoneInit.uniform(
            grid, tea=50.0, tna=50.0, n_e=1e9, B_field=1.0,
            amxwl=0.999, gmin=1e2, gmax=1e4, p_nth=2.4,
        )
        sim = Simulation(cfg, zi)
        n_tail = 0
        for _ in range(3):
            out = sim.step()
            a = sim.energy_audit()
            assert np.isclose(a["balance"], 1.0, atol=5e-3), a
            ph = sim.state.photons
            n_tail += int(jnp.sum(ph.alive & (ph.e > 1e4)))
            ev = np.asarray(out.events.data)
            nev = int(min(int(out.events.count[0]), ev.shape[0]))
            n_tail += int(np.sum(ev[:nev, 1] > 1e4))
        return n_tail

    tail_off = run(False)
    tail_on = run(True)
    assert tail_on > 2 * max(tail_off, 1), (tail_on, tail_off)


def test_strat_copies_unbiased_and_multiplies_tail():
    """strat_copies = M > 1 (the split3-analogue tail multiplicity,
    imctrk2d.f:629-661): each of M copies samples an equal sub-stratum
    of the tail with weight p_tail/M. The estimator must stay exact
    (audit ~ 1, energy totals consistent with M = 1 within MC noise)
    while the number of distinct tail samples rises with M."""
    from compton2d_tpu.config import (
        GridConfig, PhysicsConfig, RunConfig, SimConfig, SourceConfig,
        TimeWindow, ZoneInit,
    )
    from compton2d_tpu.driver import Simulation

    nz, nr = 2, 2
    grid = GridConfig(
        nz=nz, nr=nr, z_max=1e15, r_max=1e15,
        num_nt=120, n_vol=48, nphfield=48, n_gg=16, n_ref=50, nmu=4,
        spectral_regions=((1e-4, 1e-1, 10), (1e-1, 1e7, 30)),
        lc_bands=((2.0, 10.0),),
    )
    win = TimeWindow(
        t0=0.0, t1=1e30, tbb_lower=(0.5,) * nr, tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz, tbb_outer=(0.0,) * nz,
    )

    def run(copies, seed=0):
        cfg = SimConfig(
            grid=grid, physics=PhysicsConfig(t_const=True),
            source=SourceConfig(
                nst=1000, strat_split=True, strat_gamma_c=1e3,
                strat_copies=copies,
            ),
            run=RunConfig(seed=seed, n_slots=16384,
                          event_capacity=16384, max_flight_iters=256),
            windows=(win,),
        )
        zi = ZoneInit.uniform(
            grid, tea=50.0, tna=50.0, n_e=1e9, B_field=1.0,
            amxwl=0.999, gmin=1e2, gmax=1e4, p_nth=2.4,
        )
        sim = Simulation(cfg, zi)
        n_tail, e_esc = 0, 0.0
        for _ in range(3):
            out = sim.step()
            a = sim.energy_audit()
            assert np.isclose(a["balance"], 1.0, atol=5e-3), a
            ph = sim.state.photons
            n_tail += int(jnp.sum(ph.alive & (ph.e > 1e4)))
            e_esc += a["escaped"]
        return n_tail, e_esc, a["census"]

    tail1, esc1, cen1 = run(1)
    tail4, esc4, cen4 = run(4)
    # tail statistics scale with M (within the all-or-nothing
    # placement's slot budget)
    assert tail4 > 2 * max(tail1, 1), (tail4, tail1)
    # energy totals unbiased: PAIRED same-seed comparison (the parent
    # stream is shared, so M only redistributes the tail-copy
    # estimator; a cross-seed comparison would be jackpot-dominated —
    # measured seed-to-seed spread of escaped energy is ~30x in this
    # config while the paired M=1-vs-4 difference is ~3%)
    assert np.isclose(esc4, esc1, rtol=0.15), (esc4, esc1)
    assert np.isclose(cen4, cen1, rtol=0.15), (cen4, cen1)
