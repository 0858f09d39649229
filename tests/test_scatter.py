"""Compton scatter kernel physics tests: energy shift moments against
analytic Comptonization theory."""
import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu.physics import electron_dist as ed
from compton2d_tpu.transport import scatter as sc


def _thermal_cdf(gnt, n, t_kev=100.0):
    """CDF of a thermal distribution representable on the gnt grid."""
    f = ed.init_f_nt(
        jnp.asarray(gnt),
        jnp.full((1, 1), t_kev),
        jnp.full((1, 1), 1.0),
        jnp.full((1, 1), 1e3),
        jnp.full((1, 1), 1e5),
        jnp.full((1, 1), 2.5),
    )
    cdf = ed.build_cdf(f, jnp.asarray(gnt))
    return jnp.broadcast_to(cdf[0, 0], (n, cdf.shape[-1]))


def test_cold_thomson_recoil():
    """Low-energy photons on (prescribed) cold electrons:
    <dE/E> = -E/mc^2 recoil. The gnt grid cannot represent cold
    electrons (floor gamma-1 = 0.18, as in the reference), so prescribe
    them via draw_electron."""
    gnt = ed.gnt_grid(200)
    n = 60000
    e0 = 5.0  # keV

    def cold(key):
        g = jnp.full((n,), 1.0 + 1e-9, jnp.float32)
        b = jnp.full((n,), 1e-5, jnp.float32)
        return g, b, jnp.zeros((n,), jnp.int32)

    res = sc.scatter(
        jax.random.key(0),
        jnp.full((n,), e0, jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n, gnt.shape[0])), jnp.asarray(gnt),
        draw_electron=cold,
    )
    shift = float(jnp.mean(res.e)) / e0 - 1.0
    assert np.isclose(shift, -e0 / 511.0, atol=1e-3)


def test_inverse_compton_amplification():
    """Mono-energetic isotropic electrons, Thomson regime:
    <E'/E> = (4/3) gamma^2 - 1/3 (classic single-scatter result with
    the relativistic flux factor)."""
    gnt = ed.gnt_grid(200)
    n = 120000
    e0 = 0.1  # keV; gamma*E << mc^2 keeps KN corrections tiny
    g0 = 2.0
    b0 = float(np.sqrt(1 - 1 / g0**2))

    def mono(key):
        return (
            jnp.full((n,), g0, jnp.float32),
            jnp.full((n,), b0, jnp.float32),
            jnp.zeros((n,), jnp.int32),
        )

    key = jax.random.key(1)
    mu0 = jax.random.uniform(key, (n,), jnp.float32, -1.0, 1.0)
    res = sc.scatter(
        jax.random.key(11),
        jnp.full((n,), e0, jnp.float32),
        mu0,
        jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n, gnt.shape[0])), jnp.asarray(gnt),
        draw_electron=mono,
    )
    amp = float(jnp.mean(res.e)) / e0
    expect = (4.0 / 3.0) * g0**2 - 1.0 / 3.0
    assert np.isclose(amp, expect, rtol=0.02)


def test_isotropy_cold():
    """Scattering isotropic photons off an isotropic bath stays isotropic."""
    gnt = ed.gnt_grid(200)
    n = 60000
    key = jax.random.key(2)
    mu0 = jax.random.uniform(key, (n,), jnp.float32, -1.0, 1.0)
    cdf = _thermal_cdf(gnt, n)
    res = sc.scatter(
        jax.random.key(3),
        jnp.full((n,), 1.0, jnp.float32),
        mu0,
        jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        cdf, jnp.asarray(gnt),
    )
    assert abs(float(jnp.mean(res.mu))) < 0.01
    # <mu^2> = 1/3 for isotropic
    assert np.isclose(float(jnp.mean(res.mu**2)), 1.0 / 3.0, atol=0.01)
    # azimuth unit vectors stay normalized
    nrm = np.asarray(res.cphi**2 + res.sphi**2)
    assert np.allclose(nrm, 1.0, atol=1e-5)


def test_weight_scale_conserves_photon_number():
    gnt = ed.gnt_grid(200)
    n = 1000
    cdf = _thermal_cdf(gnt, n)
    e0 = jnp.full((n,), 10.0, jnp.float32)
    res = sc.scatter(
        jax.random.key(4), e0,
        jnp.zeros((n,), jnp.float32),
        jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        cdf, jnp.asarray(gnt),
    )
    # ew' / E' = ew / E  =>  wscale = E'/E
    assert np.allclose(
        np.asarray(res.wscale), np.asarray(res.e) / 10.0, rtol=1e-5
    )


def test_kn_ratio_f32_matches_f64_closed_form():
    """Regression for an f32 sampler bias: the closed-form
    KN total-sigma ratio cancels to O(z^3) near small z and amplifies
    the platform log error by ~1/z^2 — the f32 sampler must therefore
    use the series well past the cancellation region. Pin _kn_ratio_f32
    against the f64 closed form over the full Comptonization range."""
    import numpy as np
    import jax.numpy as jnp

    from compton2d_tpu.transport.scatter import _kn_ratio_f32

    z = np.geomspace(1e-5, 50.0, 400)
    z3 = z**3
    betz = 1 + 2 * z
    gamz = z * (z - 2) - 2
    small = z < 1e-3
    zs = np.where(small, 1e-3, z)
    full = 0.375 * (
        4 * zs + 2 * zs**3 * (1 + zs) / (1 + 2 * zs) ** 2
        + (zs * (zs - 2) - 2) * np.log(1 + 2 * zs)
    ) / zs**3
    series64 = 1 - z * (2 - z * (26 / 5 - z * (133 / 10 - z * (
        1144 / 35 - z * (544 / 7 - z * 7864 / 63)))))
    ref = np.where(small, series64, full)
    got = np.asarray(_kn_ratio_f32(jnp.asarray(z, jnp.float32)))
    assert np.max(np.abs(got / ref - 1)) < 5e-4, np.max(
        np.abs(got / ref - 1)
    )


def test_forced_acceptance_bias_below_mc_noise():
    """The electron+angle rejection loop keeps a fallback draw when a
    lane exhausts max_tries (the loop falls back to the init
    electron). Measure the estimator bias at
    the production max_scatter_tries=64 against an effectively
    unbounded loop — accepted-electron moments (i_gam, wscale) must
    agree within MC error. A power check (max_tries=1, where the
    fallback fires on ~half the lanes) confirms the comparison would
    detect a real bias."""
    gnt = ed.gnt_grid(100)
    n = 1 << 16
    # gate-like hybrid population: thermal + bounded gamma<=30 tail,
    # 50 keV photons -> KN acceptance well below 1 on tail draws
    f = ed.init_f_nt(
        jnp.asarray(gnt),
        jnp.full((1, 1), 100.0),
        jnp.full((1, 1), 0.5),
        jnp.full((1, 1), 3.0),
        jnp.full((1, 1), 30.0),
        jnp.full((1, 1), 2.5),
    )
    cdf = jnp.broadcast_to(
        ed.build_cdf(f, jnp.asarray(gnt))[0, 0], (n, gnt.shape[0])
    )

    def run(max_tries, seed):
        res = sc.scatter(
            jax.random.key(seed),
            jnp.full((n,), 50.0, jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.ones((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32),
            cdf, jnp.asarray(gnt),
            max_tries=max_tries,
        )
        return (
            np.asarray(res.i_gam, np.float64),
            np.asarray(res.wscale, np.float64),
        )

    def zscore(a, b):
        return abs(a.mean() - b.mean()) / np.sqrt(
            a.var() / a.size + b.var() / b.size
        )

    ig64, w64 = run(64, 0)
    ig_inf, w_inf = run(4096, 1)
    z_ig = zscore(ig64, ig_inf)
    z_w = zscore(w64, w_inf)
    assert z_ig < 4.0, f"i_gam bias at max_tries=64: z={z_ig:.2f}"
    assert z_w < 4.0, f"wscale bias at max_tries=64: z={z_w:.2f}"

    # power check: a starved loop (max_tries=1) must show a clear
    # fallback bias through exactly this comparison
    ig1, _w1 = run(1, 2)
    assert zscore(ig1, ig_inf) > 10.0, (
        "bias comparison has no statistical power"
    )
