"""Per-zone volume emissivities, opacities and emission CDFs.

Re-implements the active paths of ``/root/reference/src/volume2d.f``
(``volume_em``) and the per-zone energy budget of
``/root/reference/src/imcgen2d.f:203-335``, vectorized over all zones:

- exact nonthermal synchrotron emissivity j_sy and self-absorption
  kappa_sy from the evolving electron distribution f_nt, using the
  K_{4/3} K_{1/3} form of the single-electron synchrotron function
  (volume2d.f:206-239, expk13/expk43 fits volume2d.f:672-746);
- the emission split rule (volume2d.f:342-369): optically thin bins
  (kappa < max(1/l_min, 10 kappa_C)) build the MC volume-emission CDF
  ``eps_tot``; optically thick bins emit as a thermal surface term with
  blackbody j_th * (1 - exp(-tau)) into ``eps_th`` / ``Eloss_th``;
- total synchrotron energy loss Eloss_sy = 1.058e-15 n_e dt B^2
  sum (gamma^2-1) f dgamma vol (imcgen2d.f:280-286) — the active
  Eloss_tot (bremsstrahlung/cyclotron/pair-annihilation losses are
  computed in the reference but excluded from the budget,
  imcgen2d.f:328-331; we keep bremsstrahlung as a diagnostic);
- equipartition magnetic field options (ep_switch, imcgen2d.f:216-236).

Design: the synchrotron function F(t) is a universal 1-D shape,
tabulated once on a log grid (host numpy f64 -> f32 device constant);
the per-zone (n_vol x num_nt) contraction against f_nt then uses
gathers + matmul-style reductions batched over zones.

float32 + unit scaling: geometry arrives scaled (lengths /L, see
compton2d_tpu.units); energies leave scaled (/E). Frequency powers that
would overflow f32 (nu^3 ~ 1e64 Hz^3) are factored through nu/1e21.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn
from compton2d_tpu.units import Scales

_SIGMA_T = 6.6524616e-25
_E_CHARGE = 4.803e-10
_E_MASS = 9.109e-28
_NU_FOLD = 1.0e21  # Hz; frequency folding unit for f32 safety


def expk13(t: np.ndarray) -> np.ndarray:
    """exp(t) * K_{1/3}(t) (volume2d.f:672-714). Host numpy."""
    c1, c2 = 0.35502805, 0.25881940
    ts = np.maximum(np.asarray(t, np.float64), 1e-30)
    z3 = 1.5 * ts
    zs = z3 ** (1.0 / 3.0)
    z = zs * zs
    z32 = z3 * z3
    f1 = 1.0 + z32 / 6.0 * (1.0 + z32 / 30.0 * (1.0 + z32 / 56.0))
    f2 = z * (1.0 + z32 / 12.0 * (1.0 + z32 / 42.0 * (1.0 + z32 / 90.0)))
    small = np.exp(np.minimum(ts, 1.0)) * np.pi * 1.7320508 / zs * (
        c1 * f1 - c2 * f2
    )
    zl = 1.0 / (72.0 * ts)
    poly = 1.0 - 5.0 * zl * (1.0 - 38.5 * zl)
    large = np.sqrt(0.5 * np.pi / ts) * poly / (
        1.0 + 1.0 / (1.0 + 58.0 * ts * ts)
    )
    return np.where(ts <= 1.0, small, large)


def expk43(t: np.ndarray) -> np.ndarray:
    """exp(t) * K_{4/3}(t) (volume2d.f:718-746). Host numpy."""
    ts = np.maximum(np.asarray(t, np.float64), 1e-30)
    poly_s = 1.0 + ts * (0.9757317 - 7.6790616e-2 * ts)
    small = 0.44648975 * (2.0 / ts) ** (4.0 / 3.0) * poly_s
    zl = 1.0 / (72.0 * ts)
    poly_l = 1.0 + 55.0 * zl * (1.0 - 8.5 * zl)
    large = np.sqrt(0.5 * np.pi / ts) * poly_l * (
        1.0 + 1.0 / (1.0 + 50.0 * ts * ts)
    )
    return np.where(ts <= 1.0, small, large)


def sync_kernel(t: np.ndarray) -> np.ndarray:
    """Angle-averaged single-electron synchrotron spectral shape
    (volume2d.f:206-216): t^2 [K43 K13 - 0.6 t (K43^2 - K13^2)] e^{-2t},
    t = nu / (3 gamma^2 nu_b). Host numpy."""
    t = np.asarray(t, np.float64)
    e43 = expk43(t)
    e13 = expk13(t)
    ff = t * t * (e43 * e13 - 0.6 * t * (e43 - e13) * (e43 + e13))
    return np.where(t < 1.0e4, ff * np.exp(-2.0 * np.minimum(t, 700.0)), 0.0)


class SyncKernelTable(NamedTuple):
    """Log-spaced f32 device table of sync_kernel (kept for checkpoint /
    Tables compatibility; the hot path evaluates the closed-form kernel
    elementwise instead of interpolating this table)."""

    log_t: jnp.ndarray
    val: jnp.ndarray

    @classmethod
    def build(cls, t_min=1e-12, t_max=2e4, n=2048) -> "SyncKernelTable":
        lt = np.linspace(np.log(t_min), np.log(t_max), n)
        return cls(
            log_t=jnp.asarray(lt, jnp.float32),
            val=jnp.asarray(sync_kernel(np.exp(lt)), jnp.float32),
        )

    def __call__(self, t: jnp.ndarray) -> jnp.ndarray:
        return jnp.interp(
            jnp.log(jnp.maximum(t, 1e-30)), self.log_t, self.val,
            left=self.val[0], right=0.0,
        )


def _expk13_f32(ts: jnp.ndarray) -> jnp.ndarray:
    """Device (f32, elementwise) exp(t) K_{1/3}(t); same fit as
    :func:`expk13` (volume2d.f:672-714). Input pre-clamped >= 1e-12."""
    c1, c2 = 0.35502805, 0.25881940
    z3 = 1.5 * ts
    zs = jnp.cbrt(z3)
    z = zs * zs
    z32 = z3 * z3
    f1 = 1.0 + z32 / 6.0 * (1.0 + z32 / 30.0 * (1.0 + z32 / 56.0))
    f2 = z * (1.0 + z32 / 12.0 * (1.0 + z32 / 42.0 * (1.0 + z32 / 90.0)))
    small = jnp.exp(jnp.minimum(ts, 1.0)) * (np.pi * 1.7320508) / zs * (
        c1 * f1 - c2 * f2
    )
    zl = 1.0 / (72.0 * ts)
    poly = 1.0 - 5.0 * zl * (1.0 - 38.5 * zl)
    large = jnp.sqrt(0.5 * np.pi / ts) * poly / (
        1.0 + 1.0 / (1.0 + 58.0 * ts * ts)
    )
    return jnp.where(ts <= 1.0, small, large)


def _expk43_f32(ts: jnp.ndarray) -> jnp.ndarray:
    """Device (f32, elementwise) exp(t) K_{4/3}(t) (volume2d.f:718-746)."""
    poly_s = 1.0 + ts * (0.9757317 - 7.6790616e-2 * ts)
    small = 0.44648975 * (2.0 / ts) ** (4.0 / 3.0) * poly_s
    zl = 1.0 / (72.0 * ts)
    poly_l = 1.0 + 55.0 * zl * (1.0 - 8.5 * zl)
    large = jnp.sqrt(0.5 * np.pi / ts) * poly_l * (
        1.0 + 1.0 / (1.0 + 50.0 * ts * ts)
    )
    return jnp.where(ts <= 1.0, small, large)


def sync_kernel_f32(t: jnp.ndarray) -> jnp.ndarray:
    """Device closed-form synchrotron spectral shape (volume2d.f:206-216)
    — elementwise math, no table gathers."""
    ts = jnp.clip(t, 1e-12, 2.0e4)
    e43 = _expk43_f32(ts)
    e13 = _expk13_f32(ts)
    ff = ts * ts * (e43 * e13 - 0.6 * ts * (e43 - e13) * (e43 + e13))
    return jnp.where(
        t < 1.0e4, ff * jnp.exp(-2.0 * jnp.minimum(ts, 60.0)), 0.0
    )


def equipartition_b(
    ep_switch: jnp.ndarray,   # (nz, nr) int
    tea: jnp.ndarray,         # (nz, nr) keV
    tna: jnp.ndarray,         # (nz, nr) keV
    n_e: jnp.ndarray,         # (nz, nr)
    f_pair: jnp.ndarray,      # (nz, nr)
    B_field: jnp.ndarray,     # (nz, nr) current value (kept if switch=0)
    gamma_bar_fwd,            # callable Theta -> <gamma> (table)
) -> jnp.ndarray:
    """B from electron (ep_switch=1) or proton (=2) thermal energy
    density equipartition (imcgen2d.f:216-236)."""

    def u_of(th):
        small = 1.5 * th + 7.5 * th * th
        large = gamma_bar_fwd(jnp.maximum(th, 1e-6)) - 1.0
        return jnp.where(th < 1e-2, small, large)

    th_e = cn.KEV_TO_MEC2 * tea
    ub_e = u_of(th_e) * n_e * cn.MEC2_ERG * (1.0 + 2.0 * f_pair)
    th_p = 1.066e-6 * tna
    ub_p = u_of(th_p) * n_e * 1.5e-3
    b1 = jnp.sqrt(25.13 * ub_e)
    b2 = jnp.sqrt(25.13 * ub_p)
    return jnp.where(
        ep_switch == 1, b1, jnp.where(ep_switch == 2, b2, B_field)
    )


class VolumeEmission(NamedTuple):
    """Per-zone, per-step emission tables (shapes (nz, nr, ...)).
    Opacities in 1/L; energies in E units."""

    kappa_tot: jnp.ndarray    # (nz, nr, n_vol) [1/L] synchrotron s.a.
    eps_tot: jnp.ndarray      # (nz, nr, n_vol) MC emission CDF
    eps_th: jnp.ndarray       # (nz, nr, n_vol) thick thermal CDF
    eloss_sy: jnp.ndarray     # (nz, nr) [E] per step
    eloss_th: jnp.ndarray     # (nz, nr) [E] per step
    eloss_br: jnp.ndarray     # (nz, nr) [E] diagnostic
    eloss_pa: jnp.ndarray     # (nz, nr) [E] pair-annihilation diagnostic
    eloss_tot: jnp.ndarray    # (nz, nr) [E] = active budget (fas)


def volume_em(
    e_ph: jnp.ndarray,        # (n_vol,) photon energy grid [keV]
    gnt: jnp.ndarray,         # (num_nt,)
    f_nt: jnp.ndarray,        # (nz, nr, num_nt) unit-normalized
    tea: jnp.ndarray,         # (nz, nr) [keV]
    n_e: jnp.ndarray,         # (nz, nr) [cm^-3]
    B: jnp.ndarray,           # (nz, nr) [G]
    amxwl: jnp.ndarray,       # (nz, nr)
    vol: jnp.ndarray,         # (nz, nr) [L^3] scaled volumes
    zsurf: jnp.ndarray,       # (nz, nr) [L^2] scaled surfaces
    l_min: jnp.ndarray,       # (nz, nr) [L] scaled min zone dimension
    dt: jnp.ndarray,          # [] time step [s]
    sync_tab: SyncKernelTable,
    scales: Scales,
    zone_chunk: int = 64,
    f_pair: jnp.ndarray = None,  # (nz, nr) for the eloss_pa diagnostic
) -> VolumeEmission:
    """Vectorized volume_em over all zones (volume2d.f:10-390 +
    imcgen2d.f:276-335), float32-safe."""
    nz, nr, num_nt = f_nt.shape
    n_vol = e_ph.shape[0]
    f32 = jnp.float32
    gamma = (gnt + 1.0).astype(f32)
    gamp = gamma * jnp.sqrt(jnp.maximum(gamma * gamma - 1.0, 1e-20))
    dg = jnp.diff(gnt)
    wdg = jnp.concatenate([dg, dg[-1:] * 0.0]).astype(f32)
    nu21 = (2.41487e17 / _NU_FOLD * e_ph).astype(f32)  # nu / 1e21 Hz
    de_ratio = e_ph[1] / e_ph[0]
    bin_w = (e_ph * (de_ratio - 1.0)).astype(f32)

    # host-folded constants
    k_eloss_sy = 1.058e-15 * scales.L3 / scales.E       # * n dt B^2 sum vol
    k_eloss_th = scales.L2 / scales.E                   # * dt zsurf p_th
    k_eloss_br = 5.34e-24 * scales.L3 / scales.E
    k_kappa_c = 6.65e-25 * scales.L                     # Thomson opac / n_e
    k_jth = 1.47e-47 * _NU_FOLD**3                      # j_th prefactor
    k_kap_sy = 1.0 / (8.0 * jnp.pi * _E_MASS * _NU_FOLD**2)
    kap_L = scales.L                                    # kappa [1/cm] -> 1/L

    zshape = (nz * nr,)
    if f_pair is None:
        f_pair = jnp.zeros_like(tea)
    st = {
        "f": f_nt.reshape(nz * nr, num_nt).astype(f32),
        "tea": tea.reshape(zshape).astype(f32),
        "n_e": n_e.reshape(zshape).astype(f32),
        "B": B.reshape(zshape).astype(f32),
        "vol": vol.reshape(zshape).astype(f32),
        "zsurf": zsurf.reshape(zshape).astype(f32),
        "l_min": l_min.reshape(zshape).astype(f32),
        "amxwl": amxwl.reshape(zshape).astype(f32),
        "f_pair": f_pair.reshape(zshape).astype(f32),
    }
    dt32 = dt.astype(f32)

    def per_zone(zs):
        f = zs["f"]                               # (num_nt,)
        Bz = jnp.maximum(zs["B"], 1e-20)
        nez = zs["n_e"]
        nu_b = _E_CHARGE * Bz / (2.0 * jnp.pi * _E_MASS * cn.C_LIGHT)
        ub = Bz * Bz / (8.0 * jnp.pi)
        face = 3.0**1.5 * _SIGMA_T * cn.C_LIGHT * ub / (jnp.pi * nu_b)
        nu_p21 = 9.0e3 / _NU_FOLD * jnp.sqrt(nez)  # plasma freq / 1e21

        # t(nu, gamma) = nu / (3 gamma^2 nu_b); nu_b/1e21 keeps range
        t = nu21[:, None] / (
            3.0 * gamma[None, :] ** 2 * (nu_b / _NU_FOLD)
        )
        es = face * sync_kernel_f32(t)            # (n_vol, num_nt)
        j_sy = jnp.matmul(es, f * wdg, precision=jax.lax.Precision.HIGHEST) * nez / (
            4.0 * jnp.pi
        )
        # absorption integral (volume2d.f:232-239)
        dfg = f / gamp
        slope = jnp.concatenate([dfg[:-1] - dfg[1:], dfg[-1:] * 0.0])
        kap_sy = (
            jnp.matmul(es, slope * gamp, precision=jax.lax.Precision.HIGHEST)
            * nez * k_kap_sy / (nu21 * nu21)
        )
        kap_sy = jnp.abs(kap_sy)
        below_plasma = nu21 <= nu_p21
        j_sy = jnp.where(below_plasma, 0.0, j_sy)
        kap_sy = jnp.where(below_plasma, 0.0, kap_sy)

        kappa_tot = kap_sy * kap_L                 # [1/L]
        kappa_C = k_kappa_c * nez                  # [1/L]
        thin = kappa_tot < jnp.maximum(1.0 / zs["l_min"], 10.0 * kappa_C)

        # thick bins: blackbody surface emission (volume2d.f:349-366)
        x = e_ph.astype(f32) / jnp.maximum(zs["tea"], 1e-10)
        j_th = jnp.where(
            x < 90.0,
            k_jth * nu21**3 / jnp.expm1(jnp.minimum(x, 90.0) + 1e-12),
            0.0,
        )
        tau = jnp.minimum(kappa_tot * zs["l_min"], 50.0)
        j_th = j_th * -jnp.expm1(-tau)

        w_tot = jnp.where(thin, j_sy, 0.0) * bin_w
        w_th = jnp.where(~thin, j_th, 0.0) * bin_w
        p_tot = jnp.cumsum(w_tot)
        p_th = jnp.cumsum(w_th)
        # degenerate-spectrum guard: when the zone's emission falls
        # entirely below the e_ph grid (e.g. a weak B field puts the
        # synchrotron peak under e_ph[0]), p[-1] underflows to 0 and
        # the normalized CDF would be 0 in every bin — the inverse-CDF
        # sampler then lands every photon in the TOP bin (counting
        # 0 < u across all bins), emitting the budgeted energy at
        # ~1e10 keV. Collapse such CDFs to a step at bin 0 instead:
        # the photons carry their (tiny but real) energy weight at the
        # grid floor, the nearest representable energy.
        eps_tot = jnp.where(
            p_tot[-1] > 0.0, p_tot / jnp.maximum(p_tot[-1], 1e-37), 1.0
        )
        eps_th = jnp.where(
            p_th[-1] > 0.0, p_th / jnp.maximum(p_th[-1], 1e-37), 1.0
        )

        # energy budget (imcgen2d.f:276-335), scaled energies
        sum_g2m1 = jnp.sum((gamma**2 - 1.0) * f * wdg)
        eloss_sy = (
            (k_eloss_sy * dt32) * nez * (Bz * Bz) * sum_g2m1 * zs["vol"]
        )
        eloss_th = (k_eloss_th * dt32) * zs["zsurf"] * p_th[-1]
        th_e = jnp.float32(cn.KEV_TO_MEC2) * zs["tea"]
        f_rel = 1.41 * jnp.sqrt(th_e) * (jnp.log(2.0 * th_e) + 0.9228) - 1.0
        f_rel = jnp.maximum(1.0 + th_e**2 * f_rel / (1.0 + th_e**2), 1.0)
        eloss_br = (
            (k_eloss_br * dt32) * zs["vol"] * zs["amxwl"]
            * jnp.sqrt(zs["tea"]) * f_rel * nez * nez
        )
        # pair annihilation loss diagnostic (imcgen2d.f:318-324)
        fp = zs["f_pair"]
        eloss_pa = (
            (1.223e-20 * scales.L3 / scales.E * dt32) * zs["vol"]
            * fp * (1.0 + fp) * nez * nez
            / (1.0 / (1.0 + 6.0 * th_e)
               + th_e / (jnp.log(1.123 * th_e + 1.0) + 0.25))
        )
        return dict(
            kappa_tot=kappa_tot, eps_tot=eps_tot, eps_th=eps_th,
            eloss_sy=eloss_sy, eloss_th=eloss_th, eloss_br=eloss_br,
            eloss_pa=eloss_pa,
        )

    out = jax.lax.map(per_zone, st, batch_size=zone_chunk)
    shape2 = (nz, nr)
    eloss_sy = out["eloss_sy"].reshape(shape2)
    return VolumeEmission(
        kappa_tot=out["kappa_tot"].reshape(nz, nr, n_vol),
        eps_tot=out["eps_tot"].reshape(nz, nr, n_vol),
        eps_th=out["eps_th"].reshape(nz, nr, n_vol),
        eloss_sy=eloss_sy,
        eloss_th=out["eloss_th"].reshape(shape2),
        eloss_br=out["eloss_br"].reshape(shape2),
        eloss_pa=out["eloss_pa"].reshape(shape2),
        # active budget: synchrotron only (imcgen2d.f:328-331)
        eloss_tot=eloss_sy,
    )
