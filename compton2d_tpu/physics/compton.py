"""Compton cross sections.

Implements the *active* cross-section path of the reference
(``/root/reference/src/comtot2d.f:219-247``, icoms=6): the exact
angle-averaged, electron-energy-dependent Klein-Nishina cross section
sigma_E(x, gamma) of Coppi & Blandford 1990 (their eq. 2.3, evaluated via
the dilogarithm as in ``comtot2d.f:337-352``), integrated over the zone's
hybrid electron distribution f_nt.

Design: instead of the reference's per-photon, per-zone 200-term sum
(memoized per particle in ``imctrk2d.f:170-187``), sigma_E is precomputed
once (host numpy, float64 — the device is float32-only, see
compton2d_tpu.units) on the static (n_vol photon-energy) x (num_nt gamma)
grid and contracted against the per-zone electron distributions with a
single matmul each step — (zones, num_nt) @ (num_nt, n_vol).
Tracking then only gathers + log-interpolates the per-zone table.

Also provides the closed-form total Klein-Nishina cross section
(``comtot2d.f:160-168``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn

_SIGMA_T = 6.65e-25  # cm^2; the reference's value (comtot2d.f:162)
SIGMA_T = _SIGMA_T   # public alias (must match the sigma_e tables)


def dilog_neg(x):
    """Li2(-x) for x >= 0, vectorized host numpy, float64 accurate.

    Equivalent to the CERNLIB C332 routine the reference transcribes
    (``comtot2d.f:356-433``) restricted to non-positive arguments, using
    the standard inversion + Landen reductions so the power series only
    ever sees |w| <= 1/2.
    """
    x = np.asarray(x, np.float64)
    big = x > 1.0
    xr = np.where(big, 1.0 / np.maximum(x, 1.0), x)  # xr in [0, 1]
    # Landen: Li2(-u) = -0.5*ln^2(1+u) - Li2(u/(1+u)) for the u > 1/2 branch
    landen = xr > 0.5
    w = np.where(landen, xr / (1.0 + xr), -xr)       # |w| <= 1/2

    p = np.ones_like(w)
    series = np.zeros_like(w)
    for k in range(1, 60):
        p = p * w
        series = series + p / (k * k)
    li2_xr = np.where(
        landen,
        -0.5 * np.log1p(xr) ** 2 - series,
        series,
    )
    pi2_6 = np.pi * np.pi / 6.0
    lx = np.log(np.maximum(x, 1e-300))
    return np.where(big, -pi2_6 - 0.5 * lx * lx - li2_xr, li2_xr)


def intg_v(x):
    """Antiderivative of the Coppi & Blandford (1990) eq. 2.3 integrand
    (``comtot2d.f:337-352``)."""
    x = np.asarray(x, np.float64)
    xs = np.maximum(x, 1e-300)
    return (
        -0.5 * x
        + 0.5 / (1.0 + x)
        + 4.0 * dilog_neg(x)
        + (9.0 + x + 8.0 / xs) * np.log1p(x)
    )


def sigma_e(E_keV, gamma):
    """Angle-averaged KN cross section [cm^2] seen by a photon of energy
    ``E_keV`` in an isotropic bath of electrons with Lorentz factor
    ``gamma`` (``comtot2d.f:234-239``). Broadcasts over inputs."""
    x = np.asarray(E_keV, np.float64) / cn.EMASS_KEV
    g = np.asarray(gamma, np.float64)
    g = np.maximum(g, 1.0 + 1e-12)
    beta = np.sqrt(1.0 - 1.0 / (g * g))
    small = x * g * (1.0 + beta) < 1e-2
    sig_small = _SIGMA_T * (1.0 - 2.0 * x * g)
    up = intg_v(2.0 * g * (1.0 + beta) * x)
    dn = intg_v(2.0 * g * (1.0 - beta) * x)
    xs = np.maximum(x, 1e-300)
    bs = np.maximum(beta, 1e-12)
    sig_full = 0.09375 * _SIGMA_T / (g * g * bs * xs * xs) * (up - dn)
    return np.where(small, sig_small, sig_full)


def kn_total_sigma(E_keV):
    """Closed-form total KN cross section [cm^2] for cold electrons
    (``comtot2d.f:160-168``). Host numpy."""
    x = np.asarray(E_keV, np.float64) / cn.EMASS_KEV
    small = x < 1e-3
    sig_small = _SIGMA_T * (1.0 - 2.0 * x + 26.0 * x * x / 5.0)
    xs = np.maximum(x, 1e-6)
    t = 1.0 + 2.0 * xs
    sig_full = (
        _SIGMA_T * 0.75 * (
            (1.0 + xs) / xs**3
            * (2.0 * xs * (1.0 + xs) / t - np.log(t))
            + 0.5 / xs * np.log(t)
            - (1.0 + 3.0 * xs) / (t * t)
        )
    )
    return np.where(small, sig_small, sig_full)


def sigma_e_table(E_grid, gnt) -> np.ndarray:
    """Static table sigma_E on the (photon-energy grid) x (gamma grid),
    shape (n_E, num_nt). Host numpy float64, computed once at setup."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    return sigma_e(
        np.asarray(E_grid, np.float64)[:, None], gamma[None, :]
    )


def zone_sigma_table(
    sigma_tab: jnp.ndarray,   # (n_E, num_nt)
    f_nt: jnp.ndarray,        # (nz, nr, num_nt) normalized distribution
    gnt: jnp.ndarray,         # (num_nt,)
    n_e: jnp.ndarray,         # (nz, nr)
    f_pair: jnp.ndarray | None = None,  # (nz, nr) positron fraction
) -> jnp.ndarray:
    """Per-zone macroscopic Compton cross section [1/cm] on the photon
    energy grid: ``n_e * sum_i sigma_E(E, gamma_i) f_nt(i) dgamma_i``
    (``comtot2d.f:219-247``), as one matmul over all zones.

    Returns shape (nz, nr, n_E). ``sigma_tab`` may be pre-scaled by the
    length unit (Tables stores sigma_E * L so the result is in 1/L,
    f32-friendly).
    """
    dg = jnp.diff(gnt)                       # (num_nt-1,)
    w = jnp.concatenate([dg, dg[-1:] * 0.0])  # trapezoid-left, last bin 0
    fw = f_nt * w                             # (nz, nr, num_nt)
    # contract the gamma axis
    sig = jnp.einsum(
        "zrg,eg->zre", fw, sigma_tab, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )
    ne = n_e
    if f_pair is not None:
        ne = ne * (1.0 + 2.0 * f_pair)  # pair enhancement (imctrk2d.f:164-168)
    return jnp.maximum(sig * ne[..., None], 1e-30)
