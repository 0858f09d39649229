"""Analytic physics goldens (oracle substitutes;
the reference Fortran cannot be compiled in this image — no gfortran /
MPI — so these pin the same physics to closed-form limits instead):

- Chang-Cooper relaxes to the Maxwell-Juttner distribution for a
  thermal-bath operator (the defining CC property; oracle
  update2d.f:1363-1468);
- repeated Compton scattering off thermal electrons saturates to the
  Wien spectrum: number dist ~ E^2 exp(-E/Te), <E> -> 3 Te;
- the Kompaneets single-scatter gain <dE/E> = 4 Theta for soft photons.
"""
import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn
from compton2d_tpu.fp.chang_cooper import chang_cooper_coeffs, thomas_solve
from compton2d_tpu.physics.electron_dist import (
    gnt_grid,
    maxwell_juttner_shape,
)
from compton2d_tpu.transport.scatter import scatter


def test_chang_cooper_relaxes_to_maxwell_juttner():
    """Thermal-bath FP operator (equilibrium C f' = dgdt f with
    dgdt = D dln(f_MJ)/dgamma): any start must relax to MJ(Theta)."""
    theta = 0.2
    num_nt = 120
    gnt = jnp.asarray(gnt_grid(num_nt))
    gamma = gnt + 1.0
    beta2 = jnp.maximum(1.0 - 1.0 / gamma**2, 1e-12)
    dg = jnp.diff(gnt)
    w = jnp.concatenate([dg, dg[-1:] * 0.0])

    t0 = 100.0
    disp = gamma**2 / t0
    # d ln f_MJ / dgamma for f_MJ = gamma^2 beta exp(-(gamma-1)/Theta)
    dln = 2.0 / gamma + 1.0 / (gamma**3 * beta2) - 1.0 / theta
    dgdt = disp * dln

    # start far from equilibrium: bump at gamma ~ 30
    f = jnp.exp(-0.5 * ((jnp.log(gamma) - np.log(30.0)) / 0.25) ** 2)
    f = f / jnp.sum(f * w)
    d_t = jnp.asarray([5.0])
    for _ in range(400):
        a, b, c = chang_cooper_coeffs(
            gnt, dgdt[None, :], disp[None, :], d_t, 1e30
        )
        f = thomas_solve(a, b, c, f[None, :])[0]
        f = f / jnp.maximum(jnp.sum(f * w), 1e-300)

    mj = maxwell_juttner_shape(gnt, jnp.asarray(theta))
    mj = mj / jnp.sum(mj * w)
    # compare where MJ has appreciable support
    m = np.asarray(mj) > 1e-4 * float(jnp.max(mj))
    rel = np.abs(np.asarray(f)[m] / np.asarray(mj)[m] - 1.0)
    assert np.percentile(rel, 90) < 0.1, np.percentile(rel, 90)
    # mean gamma matches the MJ mean
    g_f = float(jnp.sum(gamma * f * w))
    g_mj = float(jnp.sum(gamma * mj * w))
    assert np.isclose(g_f, g_mj, rtol=0.02)


def _mj_electron_sampler(theta: float, n: int):
    """Exact (grid-free) MJ sampler via a fine host-side inverse CDF."""
    x = np.geomspace(1e-4, max(60.0 * theta, 2.0), 20_000)  # gamma-1
    g = x + 1.0
    b = np.sqrt(np.maximum(1.0 - 1.0 / g**2, 0.0))
    pdf = g * g * b * np.exp(-x / theta)
    cdf = np.cumsum(pdf * np.gradient(x))
    cdf /= cdf[-1]
    xs = jnp.asarray(x, jnp.float32)
    cs = jnp.asarray(cdf, jnp.float32)

    def draw(key):
        u = jax.random.uniform(key, (n,), jnp.float32, 1e-6, 1.0)
        i = jnp.clip(jnp.searchsorted(cs, u), 1, xs.shape[0] - 1)
        gm1 = xs[i - 1] + (xs[i] - xs[i - 1]) * 0.5
        gamma = gm1 + 1.0
        beta = jnp.sqrt(jnp.maximum(1.0 - 1.0 / gamma**2, 0.0))
        return gamma, beta, jnp.zeros((n,), jnp.int32)

    return draw


def test_wien_saturation():
    """Saturated Comptonization (y >> 1, no absorption): the photon
    number distribution approaches Wien at Te: <E> = 3 Te,
    <E^2>/<E>^2 = 4/3."""
    te_kev = 25.0
    theta = te_kev / cn.EMASS_KEV
    n = 60_000
    draw = _mj_electron_sampler(theta, n)

    e = jnp.full((n,), 1.0, jnp.float32)
    mu = jnp.zeros((n,), jnp.float32)
    cphi = jnp.ones((n,), jnp.float32)
    sphi = jnp.zeros((n,), jnp.float32)
    dummy_rows = jnp.zeros((n, 2), jnp.float32)
    dummy_gnt = jnp.asarray([0.1, 0.2])
    key = jax.random.PRNGKey(11)

    @jax.jit
    def one_scatter(k, e, mu, cphi, sphi):
        r = scatter(k, e, mu, cphi, sphi, dummy_rows, dummy_gnt,
                    draw_electron=draw)
        return r.e, r.mu, r.cphi, r.sphi

    for i in range(90):
        e, mu, cphi, sphi = one_scatter(
            jax.random.fold_in(key, i), e, mu, cphi, sphi
        )
    e_np = np.asarray(e, np.float64)
    m1 = e_np.mean()
    m2 = (e_np**2).mean()
    # mild relativistic corrections at Theta ~ 0.05: 8% tolerance
    assert np.isclose(m1, 3.0 * te_kev, rtol=0.08), m1
    assert np.isclose(m2 / m1**2, 4.0 / 3.0, rtol=0.08), m2 / m1**2


def test_kompaneets_single_scatter_gain():
    """Soft-photon mean relative gain per scattering = 4 Theta + 16
    Theta^2 (relativistic thermal Comptonization, e.g. Pozdnyakov,
    Sobol & Sunyaev 1983)."""
    theta = 0.05
    n = 400_000
    draw = _mj_electron_sampler(theta, n)
    e = jnp.full((n,), 1e-3, jnp.float32)
    mu = jnp.zeros((n,), jnp.float32)
    cphi = jnp.ones((n,), jnp.float32)
    sphi = jnp.zeros((n,), jnp.float32)
    r = scatter(
        jax.random.PRNGKey(3), e, mu, cphi, sphi,
        jnp.zeros((n, 2), jnp.float32), jnp.asarray([0.1, 0.2]),
        draw_electron=draw,
    )
    gain = float(jnp.mean(r.wscale)) - 1.0
    expect = 4.0 * theta + 16.0 * theta**2
    assert np.isclose(gain, expect, rtol=0.1), (gain, expect)
