"""Per-step electron update: the ``update``/``FP_calc`` phase.

Re-implements ``/root/reference/src/update2d.f`` vectorized over all
zones (the reference farms one zone per MPI worker):

- IC drift dg_ic from the tallied radiation field contracted against the
  F_IC kernel — a (zones, nphfield) @ (nphfield, num_nt) matmul
  (update2d.f:568-574);
- synchrotron drift dg_sy with the Razin-like gamma_R suppression
  (update2d.f:880-887), hard-sphere stochastic acceleration
  dg_A = gamma/t_acc, disp_A = gamma^2/(2 t_acc) (update2d.f:1035-1037);
- optional Coulomb/Moller drifts (fp_include_coulomb) and the
  bremsstrahlung drift dg_br = -f_br * gamma^1.1 normalized to the
  tallied Eloss_br (fp_include_bremsstrahlung; update2d.f:864-878) —
  both computed by the reference but excluded from its active operator
  (update2d.f:1048-1049), so both default off here;
- implicit sub-stepping with d_t = f_t_implicit * dt,
  f_t_implicit = clip(df_implicit*Te/|dT|, df_T) (update2d.f:662-666),
  as a bounded while_loop with per-zone completion masks;
- shock-front / pick-up injection (update2d.f:1229-1301) and escape
  (update2d.f:1309-1313);
- Chang-Cooper + Thomas solve each substep, renormalization, and the
  temperature update by inverting gamma_bar (update2d.f:1440-1468) via
  the monotone table;
- adaptive global time step dt_new from dT_max (update2d.f:232-243) and
  the [temp_min, temp_max] clamp (update2d.f:266-276).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from compton2d_tpu import constants as cn
from compton2d_tpu.config import PhysicsConfig
from compton2d_tpu.fp.chang_cooper import (
    chang_cooper_coeffs,
    pcr_solve,
    thomas_solve,
)
from compton2d_tpu.physics import electron_dist as ed
from compton2d_tpu.state import ZoneState
from compton2d_tpu.tables import Tables
from compton2d_tpu.units import Scales


class FPResult(NamedTuple):
    zones: ZoneState
    dt_new: jnp.ndarray        # () adapted next step
    dT_max: jnp.ndarray        # () max relative temperature change
    e_el_old: jnp.ndarray      # () total electron energy before [erg]
    e_el_new: jnp.ndarray      # () after [erg]
    substeps: jnp.ndarray      # () max substeps used
    incomplete: jnp.ndarray    # () zones whose substep loop ran out of
                               # budget with t_fp < dt (should be 0: the
                               # d_t floor guarantees completion)


def fp_step(
    zones: ZoneState,
    n_field: jnp.ndarray,      # (nz, nr, nphfield) scaled field tally
                               # (sum of w_scaled / E_keV per bin)
    tables: Tables,
    vol: jnp.ndarray,          # (nz, nr) [L^3] scaled volumes
    z_max: float,              # [cm] physical domain height
    dz: jnp.ndarray,           # [L] scaled z spacing (shock front)
    dt: jnp.ndarray,           # () current MC step [s]
    time: jnp.ndarray,         # () [s]
    eloss_sy: jnp.ndarray,     # (nz, nr) [E] per step (for hr_th_sy)
    phys: PhysicsConfig,
    scales: Scales = None,
    dn_pp: jnp.ndarray = None,   # (nz, nr, num_nt) pair production src
    dne_pa: jnp.ndarray = None,  # (nz, nr, num_nt) e- annihilation sink
    dnp_pa: jnp.ndarray = None,  # (nz, nr, num_nt) e+ annihilation sink
    coulomb=None,                # CoulombTables (fp_include_coulomb)
    j_row: jnp.ndarray = None,   # (nz, nr) z-row index of each zone
                                 # (shock front); default arange(nz)
    slab_vol: jnp.ndarray = None,  # () swept z-slab volume [L^3];
                                 # default sum(vol)/nz. Both must be
                                 # passed explicitly when the zone axis
                                 # is device-sharded (parallel zone
                                 # farm, update2d.f:190-214 analogue)
    zone_valid: jnp.ndarray = None,  # (nz, nr) bool; False marks pad
                                 # zones of a device-sharded slice:
                                 # injection and the e_el audit sums are
                                 # gated so padding never contributes
    eloss_br: jnp.ndarray = None,  # (nz, nr) [E] per step; enables the
                                 # dg_br drift when
                                 # phys.fp_include_bremsstrahlung is set
) -> FPResult:
    """All energies scaled by scales.E, volumes by scales.L^3; heating
    rates hr_* are in E/s. Rates (1/s) need no scaling."""
    if scales is None:
        scales = Scales(L=1.0, E=1.0)
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    f32 = jnp.float32
    gnt = tables.gnt.astype(f32)
    gamma = gnt + 1.0
    dg = jnp.diff(gnt)
    wdg = jnp.concatenate([dg, dg[-1:] * 0.0])

    t_esc = phys.r_esc * z_max / cn.C_LIGHT
    t_acc = phys.r_acc * z_max / cn.C_LIGHT

    # host-folded constants (see compton2d_tpu.units)
    k_mec2_vol = scales.mec2_vol             # mec2 L^3 / E
    k_dgic = scales.nfield_to_dgic           # E * 6.25e8 / L^3
    # dT[keV] = k_dT * dt * hr_scaled / (vol_s * n_lept)
    k_dT = 6.25e8 * scales.E / (1.5 * scales.L3)
    # Coulomb heating fold: hr_coul_s = k_coul*(vol_s n_lept) n_p ...
    k_coul = 1.5 * 1.7386e-26 * scales.L3 / scales.E

    # ---- flatten zones ------------------------------------------------
    f_old = zones.f_nt.reshape(Z, num_nt).astype(f32)
    sum_p = jnp.maximum(jnp.sum(f_old * wdg, axis=-1, keepdims=True), 1e-30)
    f_old = f_old / sum_p
    n_p = zones.n_e.reshape(Z).astype(f32)
    f_pair = zones.f_pair.reshape(Z).astype(f32)
    ne = n_p * (1.0 + f_pair)
    n_lept = ne + n_p * f_pair
    volume = vol.reshape(Z).astype(f32)
    B = jnp.maximum(zones.B_field.reshape(Z).astype(f32), 1e-20)
    tea0 = zones.tea.reshape(Z).astype(f32)
    tna = zones.tna.reshape(Z).astype(f32)
    turb = zones.turb_lev.reshape(Z).astype(f32)

    if zone_valid is None:
        valid = jnp.ones((Z,), bool)
    else:
        valid = zone_valid.reshape(Z)

    # electron energy audit (update2d.f:482-497), scaled energies
    def e_tot(f, nloc):
        return (
            jnp.sum(f * gamma * wdg, axis=-1)
            * (nloc * (k_mec2_vol * volume))
        )

    e_el_old = jnp.sum(jnp.where(valid, e_tot(f_old, ne), 0.0))

    # ---- static drift pieces -----------------------------------------
    # IC drift: (Z, nph) @ (nph, num_nt) (update2d.f:568-574)
    nf = n_field.reshape(Z, -1).astype(f32)
    dg_ic = -jnp.matmul(nf, tables.f_ic.T, precision=jax.lax.Precision.HIGHEST) * (
        k_dgic / volume[:, None]
    )

    f_sy = 1.058e-15 * B * B / cn.MEC2_ERG             # (Z,) 1/s
    dg_A = gamma[None, :] / t_acc
    disp_A = gamma[None, :] ** 2 / (2.0 * t_acc)

    # bremsstrahlung drift dg_br = -f_br * gamma^1.1 with f_br
    # normalized so the distribution-integrated loss rate equals the
    # tallied emissivity Eloss_br (update2d.f:674-676, 864-865, 878)
    dg_br = None
    if phys.fp_include_bremsstrahlung and eloss_br is not None:
        sum_g11 = jnp.sum(gamma ** 1.1 * f_old * wdg, axis=-1)
        f_br = eloss_br.reshape(Z).astype(f32) / jnp.maximum(
            (k_mec2_vol * volume) * dt.astype(f32) * n_lept * sum_g11,
            1e-30,
        )
        dg_br = -f_br[:, None] * gamma[None, :] ** 1.1

    # flare turbulence enhancement (update2d.f:543-558) is applied by the
    # driver as a time/space Gaussian added to turb_lev before calling in
    tlev = turb

    th_p = tna / 9.382e5
    lnL = phys.lnL

    inj = phys.injection
    if j_row is None:
        jrow_flat = jnp.repeat(jnp.arange(nz, dtype=f32), nr)
    else:
        jrow_flat = j_row.reshape(Z).astype(f32)
    if slab_vol is None:
        slab_vol = jnp.sum(volume) / nz
    use_pairs = bool(phys.pair_switch) and dn_pp is not None
    if use_pairs:
        dn_pp_f = dn_pp.reshape(Z, num_nt).astype(f32)
        dne_pa_f = dne_pa.reshape(Z, num_nt).astype(f32)
        dnp_pa_f = dnp_pa.reshape(Z, num_nt).astype(f32)
    npos0 = zones.n_pos.reshape(Z, num_nt).astype(f32)

    # ---- substep loop -------------------------------------------------
    def cool_heat_rates(f, th_e, te):
        g_av = tables.gamma_bar.forward(jnp.maximum(th_e, 1e-6))
        gamma_R = 2.1e-3 * jnp.sqrt(n_lept) / (B * jnp.sqrt(g_av))
        # hr_th_c [E/s]: sum(dg_ic f dg) * mec2 * vol_cm * n_lept / E
        hr_th_c = -jnp.sum(
            dg_ic * f * wdg, axis=-1
        ) * ((k_mec2_vol * volume) * n_lept)
        y = gamma_R / g_av
        hr_th_sy = jnp.where(
            y < 90.0,
            -eloss_sy.reshape(Z).astype(f32)
            / (dt.astype(f32) * jnp.exp(jnp.minimum(y, 90.0))),
            0.0,
        )
        h_T = 0.79788 * (
            2.0 * (th_e + th_p) ** 2 + 2.0 * (th_e + th_p) + 1.0
        ) / (
            (jnp.maximum(th_e + th_p, 1e-12)) ** 1.5
            * (1.0 + 1.875 * th_e + 0.8203 * th_e**2)
        )
        hr_th_coul = (
            (k_coul * n_p) * (volume * n_lept) * lnL * h_T * (tna - te)
        )
        hr_th_A = jnp.maximum(tlev * hr_th_coul, 1e-30)
        return hr_th_sy + hr_th_c + hr_th_A, gamma_R

    def body(carry):
        it, t_fp, f, th_e, npz, nlept_z, npos, grow, done = carry
        te = th_e * jnp.float32(cn.EMASS_KEV)
        hr_total, gamma_R = cool_heat_rates(f, th_e, te)

        # substep size (update2d.f:662-666, 1142-1146)
        dT_tot = (k_dT * dt.astype(f32)) * hr_total / jnp.maximum(
            volume * n_lept, 1e-30
        )
        f_imp = jnp.clip(
            cn.DF_IMPLICIT * te / jnp.maximum(jnp.abs(dT_tot), 1e-30),
            0.0, cn.DF_T,
        )
        d_t = f_imp * dt
        # stiff-zone floor: the df_implicit rule makes d_t ~ 1/rate,
        # so a zone whose cooling time is << dt would need unbounded
        # substeps (the reference's loop is unbounded and would
        # effectively hang there; our fp_max_substeps cap used to
        # leave such zones FROZEN at t_fp = 0). The Chang-Cooper
        # discretization is fully implicit — unconditionally stable —
        # so flooring d_t lets stiff zones relax toward their
        # (Compton/Coulomb) equilibrium within the substep budget
        # instead of not evolving at all; accuracy degrades gracefully
        # from dT-tracking to equilibrium-seeking.
        #
        # The floor backs off GEOMETRICALLY per zone (x1.25 each
        # floored substep): a zone pinned at the floor is already past
        # the df_implicit accuracy target, and repeated implicit
        # relaxation with growing steps reaches the same equilibrium,
        # so a fully stiff zone completes in ~log1.25(fp_max_substeps)
        # ~ 25 substeps instead of fp_max_substeps — in practice free,
        # because the rule-driven (non-stiff) zones bound the batched
        # while_loop at a similar count anyway. Measured on the bench
        # corona's stiff disk-adjacent zones: the 2-step Te lands
        # within ~2 keV of the fixed-floor (256-substep) answer and
        # converges to the same Compton equilibrium over later steps,
        # at ~10x less FP wall time.
        # (1.001x so the f32 partial sums cannot undershoot dt)
        floor = (1.001 * dt / phys.fp_max_substeps) * grow
        floored = d_t < floor
        d_t = jnp.maximum(d_t, floor)
        grow = jnp.where(floored & ~done, grow * 1.25, grow)
        # final substep: land on t_fp == dt exactly (an f32-rounded
        # `t_fp + d_t` can stall a few ulp short of dt forever)
        last = d_t >= dt - t_fp
        d_t = jnp.where(last, dt - t_fp, d_t)
        d_t = jnp.maximum(d_t, 1e-30)

        # ---- pair sources/sinks (update2d.f:1185-1221) -------------
        if use_pairs:
            dlt = d_t[:, None]
            f = jnp.maximum(
                f + (dn_pp_f + dne_pa_f) * dlt
                / jnp.maximum(ne, 1e-30)[:, None],
                0.0,
            )
            npos = jnp.maximum(npos + (dn_pp_f + dnp_pa_f) * dlt, 0.0)

        # ---- injection (update2d.f:1229-1301) ----------------------
        n_inject = jnp.zeros((Z,))
        f_inj = f
        gauss_prof = jnp.exp(
            -((gamma - inj.gauss_g) ** 2) / (2.0 * inj.gauss_sigma**2)
        ).at[-1].set(0.0)
        if inj.pickup:
            # constant pick-up, Gaussian profile (update2d.f:1229-1245)
            psum = jnp.maximum(jnp.sum(gauss_prof * wdg), 1e-30)
            inj_rho = jnp.where(valid, inj.pickup_rate, 0.0) * d_t
            f_inj = f_inj + (
                inj_rho[:, None] * gauss_prof[None, :] / psum
                / jnp.maximum(ne, 1e-30)[:, None]
            )
            n_inject = n_inject + inj_rho
        if inj.switch != 0:
            if inj.distribution == 1:
                prof = jnp.broadcast_to(gauss_prof[None, :], (Z, num_nt))
            else:
                if inj.g2var_switch:
                    # growing upper cutoff (update2d.f:1262-1269):
                    # g2var = g2 * 10^((time + t_fp - t0) * v / z_max),
                    # i.e. one decade over the full front crossing
                    ttz = (time + t_fp - inj.t_start).astype(f32)
                    g2z = inj.g2 * 10.0 ** jnp.clip(
                        ttz * jnp.float32(inj.v / z_max), 0.0, 6.0
                    )
                    yv = gamma[None, :] / g2z[:, None]
                else:
                    yv = jnp.broadcast_to(
                        gamma[None, :] / inj.g2, (Z, num_nt)
                    )
                prof = jnp.where(
                    (gamma[None, :] > inj.g1) & (yv < 100.0),
                    gamma[None, :] ** (-inj.p)
                    * jnp.exp(-jnp.minimum(yv, 100.0)),
                    0.0,
                )
                prof = prof.at[:, -1].set(0.0)
            inj_sum = jnp.maximum(
                jnp.sum(prof * wdg[None, :], axis=-1, keepdims=True),
                1e-30,
            )                                           # (Z, 1)
            inj_e_mean = jnp.sum(
                prof * gamma[None, :] * wdg[None, :], axis=-1
            ) / inj_sum[:, 0]                           # (Z,)
            # shock front crosses zone row j during
            # (time-t0) in [dz/v*(j-1), dz/v*j] (update2d.f:1251-1253);
            # dz is in scaled L units -> convert to cm for the crossing
            # time against inj.v [cm/s]
            t_row = dz * jnp.float32(scales.L) / jnp.float32(inj.v)
            jidx = jrow_flat
            tt = time + t_fp - inj.t_start
            active = (tt > t_row * jidx) & (tt < t_row * (jidx + 1))
            # injection normalized to the swept z-slab volume
            # pi r_max^2 dz (update2d.f:1286); luminosity folded with
            # L^3 host-side to stay in f32 range
            lum_fold = float(inj.luminosity) / (8.186e-7 * scales.L3)
            inj_rate = lum_fold / jnp.maximum(inj_e_mean * slab_vol, 1e-30)
            # no injection when the profile is unrepresentable on the
            # gamma grid (g1 above gnt[-1]): inj_sum ~ 0 would otherwise
            # blow the rate up through the floor
            ok_inj = inj_sum[:, 0] > 1e-20
            inj_rho = jnp.where(
                active & ok_inj & valid, inj_rate * d_t, 0.0
            )
            f_inj = f_inj + (
                inj_rho[:, None] * prof / inj_sum
                / jnp.maximum(ne, 1e-30)[:, None]
            )
            n_inject = n_inject + inj_rho
        npz = npz + n_inject
        nlept_z = nlept_z + n_inject

        # ---- escape of particles (update2d.f:1309-1313) ------------
        esc_fac = t_esc / (t_esc + d_t)
        npz = npz * esc_fac
        nlept_z = nlept_z * esc_fac

        # ---- operator (active terms, update2d.f:1048-1049) ---------
        y_sy = gamma_R[:, None] / gamma[None, :]
        dg_sy = jnp.where(
            y_sy < 100.0,
            -f_sy[:, None] * (gamma[None, :] ** 2 - 1.0)
            / jnp.exp(jnp.minimum(y_sy, 100.0)),
            -1e-50,
        )
        dgdt = dg_sy + dg_ic + dg_A
        if dg_br is not None:
            dgdt = dgdt + dg_br
        disp = disp_A
        if phys.fp_include_coulomb:
            if coulomb is not None:
                # exact Moller/Coulomb tables (physics/coulomb.py)
                dg_ce_t, disp_ce_t, dg_cp_t, disp_cp_t = coulomb.lookup(
                    None, te, tna
                )
                dgdt = dgdt + dg_ce_t * nlept_z[:, None] \
                    + dg_cp_t * npz[:, None]
                disp = disp + disp_ce_t * nlept_z[:, None] \
                    + disp_cp_t * npz[:, None]
            else:
                dg_cp, disp_cp = _coulomb_drift(gamma, tna, npz, lnL)
                dgdt = dgdt + dg_cp
                disp = disp + disp_cp

        a, b, c = chang_cooper_coeffs(gnt, dgdt, disp, d_t, t_esc)
        f_new = pcr_solve(a, b, c, f_inj)
        f_new = f_new.at[..., 0].set(0.0).at[..., -1].set(0.0)
        if use_pairs:
            # positron distribution through the same operator (trid_p,
            # update2d.f:1399, 2524-2564)
            npos_new = pcr_solve(a, b, c, npos)
            npos_new = npos_new.at[..., 0].set(0.0).at[..., -1].set(0.0)
        else:
            npos_new = npos

        s = jnp.maximum(jnp.sum(f_new * wdg, axis=-1, keepdims=True), 1e-30)
        f_new = f_new / s

        # ---- temperature from <gamma> (update2d.f:1440-1468) -------
        gbar = jnp.sum(gamma * f_new * wdg, axis=-1)
        th_new = tables.gamma_bar.inverse(gbar)

        # ---- commit for not-done zones -----------------------------
        upd = ~done
        f = jnp.where(upd[:, None], f_new, f)
        npos = jnp.where(upd[:, None], npos_new, npos)
        th_e = jnp.where(upd, th_new, th_e)
        t_fp_new = jnp.where(
            upd, jnp.where(last, dt, t_fp + d_t), t_fp
        )
        done_new = t_fp_new >= dt
        return (
            it + 1, t_fp_new, f, th_e, npz, nlept_z, npos, grow, done_new
        )

    def cond(carry):
        it, _, _, _, _, _, _, _, done = carry
        return (it < phys.fp_max_substeps) & ~jnp.all(done)

    th_e0 = (tea0 / cn.EMASS_KEV).astype(f32)
    init = (
        jnp.int32(0), jnp.zeros((Z,), f32), f_old, th_e0, n_p,
        n_lept, npos0, jnp.ones((Z,), f32), jnp.zeros((Z,), bool),
    )
    it_end, t_fp_end, f_fin, th_fin, np_fin, _, npos_fin, _, _ = (
        jax.lax.while_loop(cond, body, init)
    )
    incomplete = jnp.sum(
        jnp.where(valid, (t_fp_end < dt).astype(jnp.int32), 0)
    )

    te_new = jnp.clip(
        th_fin * cn.EMASS_KEV, phys.temp_min, phys.temp_max
    )
    # only update where protons exist (update2d.f:920-929)
    te_new = jnp.where(tna > 1.0, te_new, tea0)
    dT = jnp.abs(te_new - tea0) / jnp.maximum(te_new, 1e-30)
    dT_max = jnp.max(dT)

    e_el_new = jnp.sum(
        jnp.where(valid, e_tot(f_fin, np_fin * (1.0 + f_pair)), 0.0)
    )

    # adaptive dt (update2d.f:232-243)
    dt_new = jnp.where(
        dT_max < 0.2 * cn.DF_T, 3.0 * dt,
        jnp.where(
            dT_max < 0.75 * cn.DF_T, 1.1 * dt,
            jnp.where(
                dT_max > 5.0 * cn.DF_T, 0.33 * dt,
                jnp.where(dT_max > 1.25 * cn.DF_T, 0.75 * dt, dt),
            ),
        ),
    )

    # ---- effective nonthermal parameters (update2d.f:1654-1736) -----
    # gmin/gmax from the support of f_new, amxwl from the below-gmin
    # fraction, p_nth by matching the power-law mean energy to <gamma>
    idx = jnp.arange(num_nt)
    interior = (idx >= 4) & (idx < num_nt - 5)
    above_lo = interior & (f_fin > 1e-10)
    i_nt = jnp.argmax(above_lo, axis=-1)               # first hit
    has_lo = jnp.any(above_lo, axis=-1)
    i_nt = jnp.where(has_lo, i_nt, 4)
    above_hi = interior & (f_fin > 1e-15)
    i_hi = num_nt - 1 - jnp.argmax(above_hi[:, ::-1], axis=-1)
    i_hi = jnp.where(jnp.any(above_hi, axis=-1), i_hi, num_nt - 6)
    gmin_eff = gamma[i_nt]
    gmax_eff = gamma[i_hi]
    below = idx[None, :] < i_nt[:, None]
    sum_th = jnp.sum(jnp.where(below, f_fin * wdg, 0.0), axis=-1)
    sum_all = jnp.maximum(jnp.sum(f_fin * wdg, axis=-1), 1e-30)
    amxwl_eff = jnp.clip(sum_th / sum_all, 0.0, 1.0)
    sum_e_mean = jnp.sum(gamma * f_fin * wdg, axis=-1) / sum_all
    # p scan 0.1..10 (update2d.f:1692-1731), vectorized global best
    p_cand = jnp.arange(0.1, 10.01, 0.05, dtype=f32)    # (P,)
    nt_mask = (idx[None, :] >= i_nt[:, None]) & (idx < num_nt - 1)
    y_c = gamma[None, :] / gmax_eff[:, None]            # (Z, num_nt)
    base = jnp.where(nt_mask & (y_c < 90.0),
                     jnp.exp(-jnp.minimum(y_c, 90.0)) * wdg, 0.0)
    lg = jnp.log(gamma)
    # f_pl ~ gamma^-p e^-y: mean gamma over the PL for each candidate p
    gp = jnp.exp(-p_cand[:, None] * lg[None, :])        # (P, num_nt)
    hi = jax.lax.Precision.HIGHEST
    denom_p = jnp.einsum("zg,pg->zp", base, gp, precision=hi) + 1e-30
    numer_p = jnp.einsum(
        "zg,pg->zp", base * gamma[None, :], gp, precision=hi
    )
    miss = jnp.abs(numer_p / denom_p - sum_e_mean[:, None])
    p_eff = p_cand[jnp.argmin(miss, axis=-1)]
    pure_th = amxwl_eff > 0.9999
    gmin_eff = jnp.where(pure_th, zones.gmin.reshape(Z), gmin_eff)
    gmax_eff = jnp.where(pure_th, zones.gmax.reshape(Z), gmax_eff)
    p_eff = jnp.where(pure_th, zones.p_nth.reshape(Z), p_eff)

    f_nt_new = f_fin.reshape(nz, nr, num_nt)
    cdf_new = ed.build_cdf(f_nt_new, gnt)
    zones_new = zones._replace(
        tea=te_new.reshape(nz, nr),
        n_e=np_fin.reshape(nz, nr),
        f_nt=f_nt_new,
        cdf_nt=cdf_new,
        gmin=gmin_eff.reshape(nz, nr),
        gmax=gmax_eff.reshape(nz, nr),
        p_nth=p_eff.reshape(nz, nr),
        amxwl=jnp.where(
            pure_th, 1.0, amxwl_eff
        ).reshape(nz, nr),
    )
    if use_pairs:
        # positron census -> pair fraction (update2d.f:1215-1221)
        n_positron = jnp.sum(npos_fin * wdg, axis=-1)
        zones_new = zones_new._replace(
            n_pos=npos_fin.reshape(nz, nr, num_nt),
            f_pair=jnp.maximum(
                n_positron / jnp.maximum(np_fin, 1e-30), 0.0
            ).reshape(nz, nr),
        )
    return FPResult(
        zones=zones_new,
        dt_new=dt_new,
        dT_max=dT_max,
        e_el_old=e_el_old,
        e_el_new=e_el_new,
        substeps=it_end,
        incomplete=incomplete,
    )


class PhotonFillRates(NamedTuple):
    """Per-zone explicit thermal heating/cooling rates [erg/s per
    electron] + total [keV/s] (photon_fill, update2d.f:1747-1921)."""

    dT_coulp: jnp.ndarray   # (nz, nr) proton-electron Coulomb
    dT_sy: jnp.ndarray      # (nz, nr) synchrotron cooling
    dT_c: jnp.ndarray       # (nz, nr) Compton (from n_field x F_IC)
    dT_br: jnp.ndarray      # (nz, nr) bremsstrahlung cooling
    dT_A: jnp.ndarray       # (nz, nr) hydromagnetic acceleration
    dT_total: jnp.ndarray   # (nz, nr) [keV/s]
    d_t_opt: jnp.ndarray    # (nz, nr) [s] df_T-limited step suggestion
    te_est: jnp.ndarray     # (nz, nr) [keV] explicit Te estimate


def photon_fill(
    zones: ZoneState,
    n_field: jnp.ndarray,     # (nz, nr, nphfield) scaled field tally
    tables: Tables,
    vol: jnp.ndarray,         # (nz, nr) [L^3]
    dt: jnp.ndarray,          # () [s]
    eloss_sy: jnp.ndarray,    # (nz, nr) [E] per step
    eloss_br: jnp.ndarray,    # (nz, nr) [E] per step
    phys: PhysicsConfig,
    scales: Scales,
) -> PhotonFillRates:
    """First-cycle explicit thermal-rate estimate (photon_fill,
    update2d.f:1747-1921): called by the reference for ncycle <= 1
    before the FP farm. In the active code path its Te_new is
    immediately overwritten by FP_calc and its dt adjustment is
    commented out (update2d.f:1887,1914-1915), so this is faithfully a
    cycle-1 *diagnostic* — the reference logs the per-channel rates to
    log.txt. The rate formulas are update2d.f:1850-1886 verbatim.
    """
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    f32 = jnp.float32
    gnt = tables.gnt.astype(f32)
    dgw = jnp.concatenate([jnp.diff(gnt), jnp.zeros((1,), f32)])

    n_p = zones.n_e.reshape(Z).astype(f32)
    tea = zones.tea.reshape(Z).astype(f32)
    tna = zones.tna.reshape(Z).astype(f32)
    tlev = zones.turb_lev.reshape(Z).astype(f32)
    B = jnp.maximum(zones.B_field.reshape(Z).astype(f32), 1e-20)
    f_nt = zones.f_nt.reshape(Z, num_nt).astype(f32)
    volume = vol.reshape(Z).astype(f32)

    th_p = tna / 9.382e5                       # update2d.f:1846
    th_e = tea / 5.11e2
    g_av = tables.gamma_bar.forward(jnp.maximum(th_e, 1e-6))
    gamma_R = 2.1e-3 * jnp.sqrt(n_p) / (B * jnp.sqrt(g_av))

    h_T = 0.79788 * (
        2.0 * (th_e + th_p) ** 2 + 2.0 * (th_e + th_p) + 1.0
    ) / (
        jnp.maximum(th_e + th_p, 1e-12) ** 1.5
        * (1.0 + 1.875 * th_e + 0.8203 * th_e**2)
    )
    dT_coulp = 2.608e-26 * n_p * phys.lnL * (tna - tea) * h_T

    # Eloss [scaled E] -> erg, vol [L^3] -> cm^3: fold the ratio E/L^3
    # host-side (either factor alone can overflow f32)
    k_ul = jnp.float32(scales.E / scales.L3)
    y = gamma_R / g_av
    per_e = (
        eloss_sy.reshape(Z).astype(f32) / volume * k_ul
        / (jnp.maximum(n_p, 1e-30) * dt.astype(f32))
    )
    dT_sy = jnp.where(
        y < 100.0,
        -(2.0 / 3.0) * per_e / jnp.exp(jnp.minimum(y, 100.0)),
        0.0,
    )
    dT_br = (
        -(2.0 / 3.0) * eloss_br.reshape(Z).astype(f32) / volume * k_ul
        / (jnp.maximum(n_p, 1e-30) * dt.astype(f32))
    )

    # dT_c from the same dg_ic contraction as FP_calc
    # (update2d.f:1864-1872)
    nf = n_field.reshape(Z, -1).astype(f32)
    dg_ic = -jnp.matmul(nf, tables.f_ic.T, precision=jax.lax.Precision.HIGHEST) * (
        jnp.float32(scales.nfield_to_dgic) / volume[:, None]
    )
    dT_c = -(2.0 / 3.0) * jnp.float32(cn.MEC2_ERG) * jnp.sum(
        dg_ic * f_nt * dgw[None, :], axis=-1
    )

    dT_A = tlev * dT_coulp
    dT_total = (dT_coulp + dT_sy + dT_br + dT_c + dT_A) / 1.6e-9

    # zones without protons are skipped (update2d.f:1808-1809)
    skip = (n_p < 1e-11) | (tna < 1.0)
    dT_total = jnp.where(skip, 0.0, dT_total)
    d_t_opt = cn.DF_T * tea / jnp.maximum(jnp.abs(dT_total), 1e-30)
    te_est = tea + dt.astype(f32) * dT_total

    sh = (nz, nr)
    return PhotonFillRates(
        dT_coulp=dT_coulp.reshape(sh), dT_sy=dT_sy.reshape(sh),
        dT_c=dT_c.reshape(sh), dT_br=dT_br.reshape(sh),
        dT_A=dT_A.reshape(sh), dT_total=dT_total.reshape(sh),
        d_t_opt=d_t_opt.reshape(sh), te_est=te_est.reshape(sh),
    )


def _coulomb_drift(gamma, tna, n_p, lnL):
    """Electron-proton Coulomb drift + dispersion for the optional
    fp_include_coulomb path (update2d.f:898-907, 979-988; the exact
    Intdgcp integrals are approximated by their nonrelativistic
    Spitzer-like limits here)."""
    th_p = tna / 9.382e5
    beta = jnp.sqrt(jnp.maximum(1.0 - 1.0 / gamma**2, 1e-20))
    pref = 1.194e-14 * n_p[:, None] * lnL
    denom = (
        (1.0 + 1.875 * th_p + 0.8203 * th_p**2)[:, None]
        * jnp.sqrt(jnp.maximum(th_p, 1e-12))[:, None]
        * gamma[None, :] ** 2 * beta[None, :]
    )
    dg_cp = -pref / jnp.maximum(denom, 1e-30) * (gamma[None, :] - 1.0)
    disp_cp = jnp.abs(dg_cp) * jnp.maximum(th_p, 1e-12)[:, None]
    return dg_cp, disp_cp
