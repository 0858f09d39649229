"""Sampler moment tests: Planck sampler, Maxwell-Juttner electron draws,
gamma_bar table."""
import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu.physics import electron_dist as ed
from compton2d_tpu.physics import planck


def test_planck_moments():
    key = jax.random.key(0)
    T = jnp.full((200000,), 5.0)
    x = np.asarray(planck.sample_planck(key, T))
    # the sampler draws from the energy-weighted Planck spectrum
    # x^3/(e^x - 1) (each IMC photon carries equal energy weight):
    # <E> = 4 zeta(5)/zeta(4) T = 3.8322 T
    assert np.isclose(x.mean(), 3.8322 * 5.0, rtol=0.01)
    assert np.all(x > 0)


def test_wien_moments():
    key = jax.random.key(1)
    T = jnp.full((200000,), 2.0)
    x = np.asarray(planck.sample_planck(key, T, wien=True))
    # energy-weighted Wien: x^3 e^-x => <E> = 4T, <E^2> = 20 T^2
    assert np.isclose(x.mean(), 8.0, rtol=0.01)
    assert np.isclose((x**2).mean(), 80.0, rtol=0.03)


def test_gnt_grid():
    g = ed.gnt_grid(200)
    assert np.isclose(g[1], 0.2)
    assert np.isclose(g[2] / g[1], 1.1)
    assert g[-1] > 1e7


def test_gamma_bar_limits():
    tab = ed.GammaBarTable.build()
    # non-relativistic: gamma_bar ~ 1 + 1.5*Theta
    th = 0.01
    assert np.isclose(float(tab.forward(th)), 1.0 + 1.5 * th, rtol=2e-3)
    # inverse round-trip
    for th in [0.02, 0.1, 0.5, 1.5]:
        gb = float(tab.forward(th))
        assert np.isclose(float(tab.inverse(gb)), th, rtol=2e-2)


def test_init_f_nt_and_sampling():
    gnt = jnp.asarray(ed.gnt_grid(200))
    shape = (1, 1)
    tea = jnp.full(shape, 100.0)
    amxwl = jnp.full(shape, 1.0)
    gmin = jnp.full(shape, 1e3)
    gmax = jnp.full(shape, 1e5)
    p = jnp.full(shape, 2.5)
    f = ed.init_f_nt(gnt, tea, amxwl, gmin, gmax, p)
    # unit normalization
    dg = np.diff(np.asarray(gnt))
    tot = float(jnp.sum(f[0, 0, :-1] * dg))
    assert np.isclose(tot, 1.0, rtol=1e-10)
    # purely thermal: mean gamma from samples matches gamma_bar
    cdf = ed.build_cdf(f, gnt)
    u = jax.random.uniform(jax.random.key(2), (100000,), dtype=jnp.float64)
    cdf_rows = jnp.broadcast_to(cdf[0, 0], (u.shape[0], cdf.shape[-1]))
    gamma, beta, idx = ed.sample_gamma(u, cdf_rows, gnt)
    # compare to the same-grid quadrature mean (the gnt grid starts at
    # gamma-1 = 0.18, truncating the soft part of a 100 keV Maxwellian,
    # exactly as in the reference's grid, nontherm2d.f:52-54)
    ga = np.asarray(gnt) + 1.0
    fa = np.asarray(f[0, 0])
    dg_a = np.diff(np.asarray(gnt))
    gbar_grid = float(np.sum(ga[:-1] * fa[:-1] * dg_a))
    assert np.isclose(float(gamma.mean()), gbar_grid, rtol=0.02)


def test_hybrid_distribution_has_tail():
    gnt = jnp.asarray(ed.gnt_grid(200))
    shape = (1, 1)
    f = ed.init_f_nt(
        gnt,
        jnp.full(shape, 50.0),
        jnp.full(shape, 0.9),
        jnp.full(shape, 1e2),
        jnp.full(shape, 1e5),
        jnp.full(shape, 2.2),
    )
    fa = np.asarray(f[0, 0])
    g = np.asarray(gnt) + 1.0
    # power-law region scales ~ g^-2.2
    i1 = np.searchsorted(g, 1e3)
    i2 = np.searchsorted(g, 1e4)
    slope = np.log(fa[i2] / fa[i1]) / np.log(g[i2] / g[i1])
    assert np.isclose(slope, -2.2, atol=0.1)


def test_sync_kernel_device_matches_host():
    """The closed-form synchrotron kernel (hot path) must match the
    host float64 fit (volume2d.f:206-216) to f32 accuracy."""
    import jax.numpy as jnp
    from compton2d_tpu.physics.emissivity import (
        sync_kernel,
        sync_kernel_f32,
    )

    t = np.geomspace(1e-12, 9e3, 2000)
    ref = sync_kernel(t)
    got = np.asarray(sync_kernel_f32(jnp.asarray(t, jnp.float32)))
    m = ref > 1e-30
    assert np.max(np.abs(got[m] / ref[m] - 1.0)) < 2e-3
