"""Gamma-gamma pair physics: opacity, pair production, annihilation.

Re-implements ``/root/reference/src/pp2d.f`` and the ``kgg_calc`` opacity
of ``volume2d.f:401-441``:

- gamma-gamma absorption opacity kappa_gg(E) from the tallied hard
  photon field n_ph (Gould-Schreder style angle-averaged cross section);
- differential pair-production rate dn_pp(gamma) by the
  Boettcher-Schlickeiser analytic inner integrals (H, I_pm,
  pp2d.f:71-180);
- pair-annihilation sinks dne_pa/dnp_pa from the Svensson-style
  Moller-flux-averaged cross section (vsigma/f_vs, pp2d.f:310-355);
- the Wien-tail smoothing of the noisy MC photon field (nph_smooth,
  pp2d.f:366-457) as a vectorized grid-search fit.

Design: every physics kernel that depends only on the *static*
energy/gamma grids is precomputed host-side (numpy f64) into a tensor —
G(eps_out, eps_in) for the opacity, F(gamma, eps1, eps2) for pair
production, V(gamma_e, gamma_p) for annihilation — so the per-step
per-zone work is pure matmuls over the zone batch.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn


# ---------------------------------------------------------------------------
# gamma-gamma opacity (volume2d.f:401-441)
# ---------------------------------------------------------------------------
def _gg_mu_integral(s: np.ndarray) -> np.ndarray:
    """G(s) = int_{-1}^{mu_thr} (1-mu) f(beta) dmu with
    beta^2 = 1 - 2/(s (1-mu)), s = eps1*eps2; the reference evaluates
    this with a 100-point midpoint rule per pair (volume2d.f:419-432)."""
    s = np.asarray(s, np.float64)
    out = np.zeros_like(s)
    mask = s > 1.0
    sv = s[mask]
    mu_thr = np.minimum(1.0 - 2.0 / sv, 1.0)
    acc = np.zeros_like(sv)
    n_steps = 200
    for q in range(n_steps):
        frac = (q + 0.5) / n_steps
        dmu = (1.0 + mu_thr) / n_steps
        mu = -1.0 + frac * (mu_thr + 1.0)
        b2 = 1.0 - 2.0 / (sv * (1.0 - mu))
        ok = (b2 > 0.0) & (b2 < 1.0)
        beta = np.sqrt(np.maximum(b2, 1e-30))
        f = (1.0 - b2) * (
            (3.0 - b2 * b2) * np.log((1.0 + beta) / np.maximum(1.0 - beta, 1e-30))
            - 2.0 * beta * (2.0 - b2)
        )
        acc += np.where(ok, (1.0 - mu) * f * dmu, 0.0)
    out[mask] = acc
    return out


def kgg_matrix(e_gg: np.ndarray, length_scale: float = 1.0) -> np.ndarray:
    """Static matrix M[out, in] with
    kappa_gg(E_out) = sum_in n_ph_phys[in] * M[out, in]  [1/L].

    M = 6.234e-26 * G(eps_out*eps_in) * dE_in * L (volume2d.f:434-440).
    """
    e = np.asarray(e_gg, np.float64)
    eps = 1.957e-3 * e
    de = np.concatenate([np.diff(e), [0.0]])
    s = eps[:, None] * eps[None, :]
    G = _gg_mu_integral(s)
    return 6.234e-26 * float(length_scale) * G * de[None, :]


# ---------------------------------------------------------------------------
# pair production (pp2d.f:6-180)
# ---------------------------------------------------------------------------
def _i_pm(ecm, eps1, eps2, c):
    ee = eps1 * eps2
    with np.errstate(all="ignore"):
        d2p = ee + c * ecm**2
        pos = np.log(
            ecm * np.sqrt(np.maximum(c, 0.0))
            + np.sqrt(np.maximum(d2p, 1e-300))
        ) / np.sqrt(np.maximum(c, 1e-300))
        arg = np.clip(ecm * np.sqrt(np.maximum(-c, 0.0) / ee), -1.0, 1.0)
        neg = np.arcsin(arg) / np.sqrt(np.maximum(-c, 1e-300))
    return np.where(c > 1e-40, pos, np.where(c < -1e-40, neg, 0.0))


def _h_fn(ecm, eps1, eps2, gamma):
    ee = eps1 * eps2
    c = (eps1 - gamma) ** 2 - 1.0
    d = eps1**2 + ee + gamma * (eps2 - eps1)
    d2 = ee + c * ecm**2
    with np.errstate(all="ignore"):
        big = (
            -0.125 * ecm * (d / ee + 2.0 / c) / np.sqrt(np.maximum(d2, 1e-300))
            + 0.25 * (2.0 - (ee - 1.0) / c) * _i_pm(ecm, eps1, eps2, c)
            + 0.25 * np.sqrt(np.maximum(d2, 0.0))
            * (ecm / c + 1.0 / (ecm * ee))
        )
        small = (
            (ecm**3 / 12.0 - 0.125 * ecm * d) / ee**1.5
            + (ecm**3 / 6.0 + 0.5 * ecm + 0.25 / ecm) / np.sqrt(ee)
        )
    out = np.where(np.abs(c) > 1e-10, big, small)
    return np.where(d2 > 0.0, out, 0.0)


def _f_inner(ecm, eps1, eps2, gamma):
    E = eps1 + eps2
    f12 = E**2 - 4.0 * ecm**2
    f1 = 0.25 * np.sqrt(np.maximum(f12, 0.0))
    val = f1 + _h_fn(ecm, eps1, eps2, gamma) + _h_fn(ecm, eps2, eps1, gamma)
    return np.where(f12 >= 0.0, val, 0.0)


def f_pprod(eps1, eps2, gamma):
    """Differential pair-production kernel (pp2d.f:71-105)."""
    E = eps1 + eps2
    x = gamma * (E - gamma)
    det2 = (x + 1.0) ** 2 - E**2
    with np.errstate(all="ignore"):
        det = np.sqrt(np.maximum(det2, 0.0))
        estar2 = 0.5 * (x + 1.0 + det)
        edag2 = 0.5 * (x + 1.0 - det)
        estar = np.sqrt(np.maximum(estar2, 0.0))
        edag = np.sqrt(np.maximum(edag2, 0.0))
        ecm_u = np.minimum(np.sqrt(eps1 * eps2), estar)
        ecm_l = np.maximum(1.0, edag)
        val = _f_inner(ecm_u, eps1, eps2, gamma) - _f_inner(
            ecm_l, eps1, eps2, gamma
        )
    ok = (det2 >= 0.0) & (estar2 >= 0.0) & (edag2 >= 0.0) & (ecm_u > ecm_l)
    return np.where(ok, val, 0.0)


def pairprod_tensor(gnt: np.ndarray, e_gg: np.ndarray) -> np.ndarray:
    """Static F[gamma, p1, p2] = 1.496e-14 * f_pprod * dE1 dE2 /
    (eps1^2 eps2^2) so that
    dn_pp(z, gamma) = sum_{p1,p2} n1(z,p1) n2(z,p2) F[gamma,p1,p2]
    (pairprod, pp2d.f:24-48)."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    e = np.asarray(e_gg, np.float64)
    eps = 1.957e-3 * e
    de = np.concatenate([np.diff(e), [0.0]])
    g = gamma[:, None, None]
    e1 = eps[None, :, None]
    e2 = eps[None, None, :]
    F = f_pprod(e1, e2, g)
    w1 = (de / eps**2)[None, :, None]
    w2 = (de / eps**2)[None, None, :]
    return 1.496e-14 * F * w1 * w2


def dn_pp_from_field(
    nph_phys: jnp.ndarray,     # (Z, n_gg) photons / cm^3 / keV
    pp_tensor: jnp.ndarray,    # (num_nt, n_gg, n_gg) f32
) -> jnp.ndarray:
    """dn_pp(z, gamma) via two tensor contractions."""
    # T[z, g, p1] = sum_p2 F[g, p1, p2] n(z, p2)
    t = jnp.einsum(
        "gpq,zq->zgp", pp_tensor, nph_phys,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "zgp,zp->zg", t, nph_phys, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )


# ---------------------------------------------------------------------------
# pair annihilation (pp2d.f:187-355)
# ---------------------------------------------------------------------------
def _f_vs(gcm):
    bcm = np.sqrt(np.maximum(1.0 - 1.0 / gcm**2, 1e-30))
    L = np.log((1.0 + bcm) / np.maximum(1.0 - bcm, 1e-30))
    return bcm**3 * gcm**2 * L - 2.0 * gcm**2 + 0.75 * L**2


def vsigma_matrix(gnt: np.ndarray) -> np.ndarray:
    """V[ge_idx, gp_idx] = <sigma v> for e+e- annihilation
    (vsigma, pp2d.f:310-340), static num_nt x num_nt table."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    ge = gamma[:, None]
    gp = gamma[None, :]
    be = np.sqrt(np.maximum(1.0 - 1.0 / ge**2, 1e-20))
    bp = np.sqrt(np.maximum(1.0 - 1.0 / gp**2, 1e-20))
    gmin2 = 0.5 * (1.0 + ge * gp * (1.0 - be * bp))
    gmax2 = 0.5 * (1.0 + ge * gp * (1.0 + be * bp))
    gcm_min = np.where(gmin2 > 1.00002, np.sqrt(gmin2), 1.00001)
    gcm_max = np.where(gmax2 > 1.00002, np.sqrt(gmax2), 1.00001)
    v = 7.48e-15 * (_f_vs(gcm_max) - _f_vs(gcm_min)) / (
        be * bp * (ge * gp) ** 2
    )
    return np.where(gcm_max > gcm_min, v, 0.0)


def pa_rates(
    f_nt: jnp.ndarray,        # (Z, num_nt) unit-normalized electrons
    n_pos: jnp.ndarray,       # (Z, num_nt) positron density [cm^-3]
    n_e: jnp.ndarray,         # (Z,)
    vs: jnp.ndarray,          # (num_nt, num_nt)
    gnt: jnp.ndarray,
):
    """Annihilation sinks dne_pa, dnp_pa (pa_calc, pp2d.f:187-250)."""
    dg = jnp.diff(gnt)
    w = jnp.concatenate([dg, dg[-1:] * 0.0])
    hi = jax.lax.Precision.HIGHEST
    # (Z, num_nt) rates per electron and per positron
    pa_el = jnp.matmul(n_pos * w, vs.T, precision=hi)
    pa_po = jnp.matmul(f_nt * w, vs, precision=hi)
    dne = -n_e[:, None] * f_nt * pa_el
    dnp = -n_pos * n_e[:, None] * pa_po
    return dne, dnp


# ---------------------------------------------------------------------------
# photon-field smoothing (nph_smooth, pp2d.f:366-457)
# ---------------------------------------------------------------------------
def nph_smooth(
    nph: jnp.ndarray,      # (Z, n_gg) photon counts (any consistent unit)
    e_gg: jnp.ndarray,     # (n_gg,)
    te: jnp.ndarray,       # (Z,) electron temperatures [keV]
) -> jnp.ndarray:
    """Replace the noisy MC field by the best-fit
    N (E/E_3)^-a exp(-E/E0) over a 21 x 13 x 16 parameter grid, zones
    with too little signal left unchanged (pp2d.f:377-456)."""
    Z, ngg = nph.shape
    n1, n2 = 1, 9  # 0-based counterparts of the reference's 2 and 10
    a0 = jnp.log(
        jnp.maximum(nph[:, n1], 1e-30) / jnp.maximum(nph[:, n2], 1e-30)
    ) / jnp.log(e_gg[n2] / e_gg[n1])
    a0 = jnp.clip(a0, 1e-2, 4.0)
    N0 = jnp.maximum(nph[:, 2], 1e-30)
    E00 = jnp.maximum(te, 1.0)

    ks = jnp.arange(21, dtype=jnp.float32)
    ls = jnp.arange(13, dtype=jnp.float32)
    ms = jnp.arange(16, dtype=jnp.float32)
    Ns = 0.5 * N0[:, None] * 1.075 ** ks[None, :]          # (Z, 21)
    As = a0[:, None] - 0.5 + 0.05 * ls[None, :]            # (Z, 13)
    E0s = 0.35 * E00[:, None] * 1.15 ** ms[None, :]        # (Z, 16)

    e3 = e_gg[2]

    def chi2_of(params):
        N, a, E0 = params                                   # (Z,) each
        y = e_gg[None, :] / E0[:, None]
        f_s = jnp.where(
            y < 20.0,
            N[:, None] * (e_gg[None, :] / e3) ** (-a[:, None])
            / jnp.exp(jnp.minimum(y, 20.0)),
            0.0,
        )
        use = (f_s > 1.0) & (nph > 1.0)
        return jnp.sum(
            jnp.where(use, (nph - f_s) ** 2 / jnp.maximum(f_s, 1e-30), 0.0),
            axis=-1,
        ), f_s

    # scan the 21*13*16 = 4368 candidates in chunks via fori over one
    # flattened axis (memory-light)
    n_cand = 21 * 13 * 16

    def body(i, carry):
        best_chi, best_n, best_a, best_e = carry
        k = i // (13 * 16)
        rem = i % (13 * 16)
        l = rem // 16
        m = rem % 16
        N = Ns[:, k]
        a = As[:, l]
        E0 = E0s[:, m]
        chi, _ = chi2_of((N, a, E0))
        better = chi <= best_chi
        return (
            jnp.where(better, chi, best_chi),
            jnp.where(better, N, best_n),
            jnp.where(better, a, best_a),
            jnp.where(better, E0, best_e),
        )

    init = (
        jnp.full((Z,), 1e30, jnp.float32), N0, a0, E00,
    )
    _, Nb, ab, Eb = jax.lax.fori_loop(0, n_cand, body, init)

    y = e_gg[None, :] / Eb[:, None]
    fit = jnp.where(
        y < 20.0,
        Nb[:, None] * (e_gg[None, :] / e3) ** (-ab[:, None])
        / jnp.exp(jnp.minimum(y, 20.0)),
        0.0,
    )
    # zones without enough signal keep the raw field (pp2d.f:384-386)
    ok = (nph[:, n1] > 1.0) & (nph[:, n2] > 1.0)
    return jnp.where(ok[:, None], fit, nph)
