"""The XLA flight loop (tracking.transport_step) against closed-form
expectations: energy bookkeeping, determinism, straight-line free
streaming, the gamma-gamma absorption channel, and stratified scatter
on a photon mesh and on a grid of more than 1024 zones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu.examples import small_corona
from compton2d_tpu.state import EventBuffer, PhotonArray, Tallies
from compton2d_tpu.transport.tracking import (
    TrackContext,
    TrackStatics,
    transport_step,
)

N_GG = 32


def _tables():
    """Grids, spectral edges and reflection tables of a tiny corona."""
    return small_corona(nz=2, nr=2, nst=100, n_slots=256, num_nt=40,
                        n_vol=48, nphfield=48).tables


def _ctx(nz, nr, sig=1.0, kap=0.5, kgg=0.0, theta=0.2):
    """Uniform unit-cube zones with constant opacities [1/L]."""
    t = _tables()
    nzr = nz * nr
    n_vol = t.e_ph.shape[0]
    opac = np.zeros((nzr, n_vol, 2), np.float32)
    opac[:, :, 0] = sig
    opac[:, :, 1] = kap
    e_gg = np.geomspace(50.0, 5000.0, N_GG)
    gnt = np.asarray(t.gnt)
    cdf = np.cumsum(np.exp(-gnt / theta))
    cdf_nt = np.tile((cdf / cdf[-1])[None, :], (nzr, 1)).astype(np.float32)
    return TrackContext(
        r_edges=jnp.linspace(0.0, 1.0, nr + 1, dtype=jnp.float32),
        z_edges=jnp.linspace(0.0, 1.0, nz + 1, dtype=jnp.float32),
        opac_zone=jnp.asarray(opac),
        kgg_zone=jnp.full((nzr, N_GG), kgg, jnp.float32),
        cdf_nt=jnp.asarray(cdf_nt),
        gnt=t.gnt,
        e_ph_log0=jnp.log(t.e_ph[0]),
        e_ph_dlog=jnp.log(t.e_ph[1] / t.e_ph[0]),
        e_gg_log0=jnp.log(jnp.float32(e_gg[0])),
        e_gg_dlog=jnp.log(jnp.float32(e_gg[1] / e_gg[0])),
        e_field_log0=jnp.log(t.e_field[0]),
        e_field_dlog=jnp.log(t.e_field[1] / t.e_field[0]),
        hu=t.hu, mu_edges=t.mu_edges, lc_lo=t.lc_lo, lc_hi=t.lc_hi,
        e_ref=t.e_ref, p_ref_t=t.p_ref.T, w_abs_t=t.w_abs.T,
        tbbl_pos=jnp.zeros((nr,), bool),
        inv_nsigt=jnp.ones((nzr,), jnp.float32),
        time=jnp.float32(0.0), dt=jnp.float32(1.0),
        inv_c=jnp.float32(1.0),
    )


def _photons(n, nz, nr, seed=0, dcen=5.0, e=None):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, n)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return PhotonArray(
        e=f32(rng.uniform(1.0, 10.0, n) if e is None else np.full(n, e)),
        w=jnp.ones(n, jnp.float32), w0=jnp.ones(n, jnp.float32),
        r=f32(rng.uniform(0.1, 0.9, n)), z=f32(rng.uniform(0.1, 0.9, n)),
        mu=f32(rng.uniform(-1, 1, n)),
        cphi=f32(np.cos(phi)), sphi=f32(np.sin(phi)),
        dcen=jnp.full(n, dcen, jnp.float32),
        jz=jnp.asarray(rng.integers(0, nz, n), jnp.int32),
        kr=jnp.asarray(rng.integers(0, nr, n), jnp.int32),
        alive=jnp.ones(n, bool),
    )


def _track(ph, ctx, nz, nr, seed=1, **st_kw):
    st = TrackStatics(nz=nz, nr=nr, max_iters=128, **st_kw)
    t = Tallies.zeros(nz, nr, ctx.cdf_nt.shape[1], 48, N_GG,
                      ctx.mu_edges.shape[0], ctx.hu.shape[0] - 1,
                      ctx.lc_lo.shape[0])
    ev = EventBuffer.empty(ph.n_slots)
    return jax.jit(lambda p, t, e, k, c: transport_step(p, t, e, k, c, st))(
        ph, t, ev, jax.random.PRNGKey(seed), ctx
    )


def _escaped(t):
    return float(sum(jnp.sum(x) for x in (
        t.erlk_inner, t.erlk_outer, t.erlk_upper, t.erlk_lower)))


def test_energy_bookkeeping():
    """Photon weight in = weight alive + escaped + deposited + killed,
    with the scatter exchange counted once: it enters both the photon
    weights and edep, so 2 * e_scatter comes off."""
    nz, nr, n = 3, 2, 2048
    ph, t, _ = _track(_photons(n, nz, nr), _ctx(nz, nr), nz, nr)
    w_alive = float(jnp.sum(jnp.where(ph.alive, ph.w, 0.0)))
    total = (w_alive + _escaped(t) + float(jnp.sum(t.edep))
             + float(t.e_killed) - 2.0 * float(t.e_scatter))
    assert float(t.e_scatter) != 0.0
    np.testing.assert_allclose(total, n, rtol=2e-4)


def test_same_key_same_result():
    nz, nr = 3, 2
    o1 = _track(_photons(1024, nz, nr, seed=4), _ctx(nz, nr), nz, nr)
    o2 = _track(_photons(1024, nz, nr, seed=4), _ctx(nz, nr), nz, nr)
    for a, b in zip(jax.tree_util.tree_leaves(o1),
                    jax.tree_util.tree_leaves(o2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_free_streaming_to_census():
    """No absorption, negligible scattering: every photon flies its
    census distance in a straight line and stays in the domain."""
    nz, nr, n, d = 2, 2, 1024, 0.3
    ph0 = _photons(n, nz, nr, dcen=d)._replace(
        mu=jnp.full(n, 0.2, jnp.float32),
        z=jnp.full(n, 0.4, jnp.float32),
        r=jnp.full(n, 0.3, jnp.float32),
        jz=jnp.zeros(n, jnp.int32), kr=jnp.zeros(n, jnp.int32),
    )
    ph, t, _ = _track(ph0, _ctx(nz, nr, sig=1e-25, kap=0.0), nz, nr)
    assert bool(jnp.all(ph.alive))
    np.testing.assert_allclose(np.asarray(ph.z), 0.4 + 0.2 * d, rtol=1e-5)
    f_h = d * np.sqrt(1.0 - 0.2**2)
    r_want = np.sqrt(0.3**2 + f_h**2 + 2 * f_h * 0.3 * np.asarray(ph0.cphi))
    # f32 geometry: ~1e-6 absolute on unit-scale positions
    np.testing.assert_allclose(np.asarray(ph.r), r_want, rtol=1e-4,
                               atol=2e-6)
    assert float(jnp.sum(t.edep)) < 1e-6
    assert float(t.e_scatter) == 0.0


def test_gamma_gamma_absorption_channel():
    """pair_switch on, a strong uniform gamma-gamma opacity and no
    other absorption: > 47 keV photons lose weight to e_pair_abs, not
    to edep, and the bookkeeping closes."""
    nz, nr, n = 2, 2, 1024
    ph, t, _ = _track(
        _photons(n, nz, nr, dcen=1.0, e=100.0),
        _ctx(nz, nr, sig=1e-3, kap=0.0, kgg=3.0), nz, nr, pair_switch=1,
    )
    w_alive = float(jnp.sum(jnp.where(ph.alive, ph.w, 0.0)))
    epair = float(t.e_pair_abs)
    assert w_alive < 0.8 * n
    assert epair > 0.1 * n
    assert abs(float(jnp.sum(t.edep)) - float(t.e_scatter)) < 1e-3 * n
    total = (w_alive + _escaped(t) + float(jnp.sum(t.edep)) + epair
             + float(t.e_killed) - 2.0 * float(t.e_scatter))
    np.testing.assert_allclose(total, n, rtol=3e-4)


def _strat_corona(nz, nr, n_slots, mesh=None, **kw):
    """Optically thick corona with a rare (p ~ 1e-3) power-law tail, so
    the stratified scatter places tail copies."""
    sim = small_corona(
        nz=nz, nr=nr, nst=1000, n_slots=n_slots, tea=50.0, n_e=1e9,
        amxwl=0.999, gmin=1e2, gmax=1e4, p_nth=2.4, t_const=True, **kw,
    )
    cfg = dataclasses.replace(
        sim.cfg, source=dataclasses.replace(
            sim.cfg.source, strat_split=True, strat_gamma_c=1e3),
    )
    return sim.with_config(cfg, mesh=mesh)


def test_strat_split_on_two_device_mesh():
    from compton2d_tpu.parallel.mesh import make_photon_mesh

    mesh = make_photon_mesh(jax.devices()[:2])
    sim = _strat_corona(2, 2, 8192, mesh=mesh, num_nt=120, n_vol=48,
                        nphfield=48)
    n_tail = 0
    for _ in range(2):
        sim.step()
        a = sim.energy_audit()
        assert abs(a["balance"] - 1.0) < 2e-3, a
        ph = sim.state.photons
        n_tail += int(jnp.sum(ph.alive & (ph.e > 1e4)))
    assert n_tail > 0


def test_step_above_1024_zones():
    """36 x 36 zones: past 256 rows the strat scatter's per-photon
    electron-CDF rows come from a plain gather; the audit balances."""
    sim = _strat_corona(36, 36, 4096, num_nt=40, n_vol=32, nphfield=32)
    assert sim.cfg.grid.nz * sim.cfg.grid.nr > 1024
    out = sim.step()
    a = sim.energy_audit()
    assert abs(a["balance"] - 1.0) < 2e-3, a
    assert int(out.n_tracked) > 0
    assert np.all(np.isfinite(np.asarray(sim.state.zones.tea)))
