"""Photon sourcing: per-step energy budget and emission sampling.

Replaces the reference's photon-budget pass and both master-worker
sampling task farms (``/root/reference/src/imcgen2d.f``,
``imcvol2d_para.f``, ``imcsurf2d_para.f``) with:

1. :func:`compute_budget` — the per-step energy inputs
   (surface blackbody erin = dt * A * sigma * T^4, imcgen2d.f:125-193;
   volume fas = Eloss_tot from the emissivity pass) and the photon-count
   allocation with the reference's rules (surface counts proportional to
   boundary area, volume counts = 0.5 * nst * fas/Emiss_tot,
   imcgen2d.f:430-486) and the 10*nst bias clamp (imcgen2d.f:491-517);
2. :func:`emit` — fills free photon slots. Shape-static trick: each free
   slot's rank among free slots is matched against the cumulative count
   vector (searchsorted), so the data-dependent per-category counts never
   appear in a shape.

Source categories are laid out as
``[volume zones (nz*nr) | lower rings (nr) | upper rings (nr) |
inner rows (nz) | outer rows (nz)]``.

Volume emission splits thermally per zone: with probability
f_thermal = Eloss_th/Eloss_tot the photon is emitted from a zone *face*
with the optically-thick thermal CDF eps_th, otherwise from the zone
interior with the thin-emission CDF eps_tot (vol_calc,
imcvol2d_para.f:120-300).

Boundary photons: Planck-sampled at the cell blackbody temperature, or
(for file-spectrum boundaries, tbb < 0 in the legacy config) drawn from
an external-spectrum CDF with the beamed upward direction used for
blazar external radiation (r_surf_calc, imcsurf2d_para.f:448-459).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from compton2d_tpu import constants as cn
from compton2d_tpu.physics.planck import sample_planck
from compton2d_tpu.state import PhotonArray


# Quantile resolution of the boundary file-spectrum inverse-CDF bank:
# the device sampler is a log-e lerp between quantile knots, so
# spectral structure carrying less than ~1/M of the CDF mass is
# smeared into one log-linear segment (a deliberate approximation in
# place of an exact per-bin binary search of log2(nf) (n,)-sized
# gathers). M = 4096 resolves features down to 2.4e-4 of the total
# flux, well under MC noise at feasible photon counts.
SPEC_INV_M = 4096


class SourceBudget(NamedTuple):
    counts: jnp.ndarray      # (C,) int32 photons per category
    cum_counts: jnp.ndarray  # (C,) inclusive cumulative counts
    weights: jnp.ndarray     # (C,) f32 energy weight [energy_scale erg]
    n_new: jnp.ndarray       # () int32 total new photons
    erin_lower: jnp.ndarray  # (nr,) [erg] for the energy audit
    erin_upper: jnp.ndarray  # (nr,)
    erin_inner: jnp.ndarray  # (nz,)
    erin_outer: jnp.ndarray  # (nz,)
    bingo: jnp.ndarray       # () [erg] total fresh energy input + census


class SourceStatic(NamedTuple):
    """Per-window boundary data (device arrays, rebuilt on the host when
    the boundary-condition time window changes — the shapes are fixed by
    the spectrum bank so swapping windows never recompiles the step)."""

    tbb_lower: jnp.ndarray   # (nr,) [keV]; <0 means file spectrum
    tbb_upper: jnp.ndarray   # (nr,)
    tbb_inner: jnp.ndarray   # (nz,)
    tbb_outer: jnp.ndarray   # (nz,)
    # external file-spectrum bank: every distinct spectrum file across
    # all windows gets a row (padded to a common length); each boundary
    # ring indexes its row (reader.f:231-241 allows a file per ring per
    # side per window; file_sp builds the CDF, imcsurf2d_para.f:544-685)
    spec_e: jnp.ndarray      # (n_spec, nf) energy grids [keV]
    spec_cdf: jnp.ndarray    # (n_spec, nf) sampling CDFs
    spec_inv: jnp.ndarray    # (n_spec, SPEC_INV_M) log-e inverse-CDF
                             # quantile table (built host-side)
    spec_lower: jnp.ndarray  # (nr,) int32 bank row per lower ring
    spec_upper: jnp.ndarray  # (nr,) int32 bank row per upper ring
    flux_lower: jnp.ndarray  # (nr,) integrated file flux [E/L^2/s]
    flux_upper: jnp.ndarray  # (nr,)
    star_dilution: jnp.ndarray  # () (Rstar/dist)^2 or 1


def compute_budget(
    src: SourceStatic,
    fas: jnp.ndarray,         # (nz, nr) volume emission per step [E]
    ecens: jnp.ndarray,       # (nz, nr) census energy [E]
    ed_abs: jnp.ndarray,      # (nr,) disk-absorbed energy [E]
    area_lower, area_upper, area_inner, area_outer,  # scaled areas [L^2]
    dt: jnp.ndarray,
    dt_prev: jnp.ndarray,
    nst: int,
    bias_cap: float,
    sigma_sb_scaled: float,   # sigma_SB * L^2 / E (Scales.sigma_sb)
    dh_sentinel: bool = False,
    replicas: int = 1,
) -> SourceBudget:
    nz = area_inner.shape[0]
    nr = area_lower.shape[0]
    f32 = jnp.float32
    dt32 = dt.astype(f32)

    def erin_of(tbb, area, flux=None, dilution=None):
        """erin = dt*A*sigma*T^4 for thermal rings (star dilution applies
        to the thermal branch only, imcgen2d.f:161-163), or the per-ring
        integrated file flux for tbb < 0 rings (imcgen2d.f:127-130)."""
        tbb = tbb.astype(f32)
        t4 = jnp.maximum(tbb, 0.0) ** 2
        bb = (dt32 * sigma_sb_scaled) * area.astype(f32) * t4 * t4
        if dilution is not None:
            bb = bb * dilution.astype(f32)
        if flux is None:
            file_in = jnp.zeros_like(bb)
        else:
            file_in = dt32 * area.astype(f32) * flux.astype(f32)
        return jnp.where(tbb > 0.0, bb, jnp.where(tbb < 0.0, file_in, 0.0))

    erin_l = erin_of(src.tbb_lower, area_lower, src.flux_lower)
    if dh_sentinel:
        # disk re-heating by absorbed flux (imcgen2d.f:178-183)
        erin_l = erin_l + jnp.where(
            src.tbb_lower > 1e-20,
            ed_abs.astype(f32) * dt32
            / jnp.maximum(dt_prev.astype(f32), 1e-30),
            0.0,
        )
    erin_u = erin_of(
        src.tbb_upper, area_upper, src.flux_upper,
        dilution=src.star_dilution,
    )
    erin_i = erin_of(src.tbb_inner, area_inner)
    erin_o = erin_of(src.tbb_outer, area_outer)

    fas = fas.astype(f32)
    emiss_tot = jnp.maximum(jnp.sum(fas), 1e-30)
    bingo = (
        jnp.sum(ecens.astype(f32)) + jnp.sum(fas)
        + jnp.sum(erin_i) + jnp.sum(erin_o)
        + jnp.sum(erin_l) + jnp.sum(erin_u)
    )

    # photon counts (imcgen2d.f:700-730): upper/lower rings by annulus
    # area fraction (r_k^2 - r_{k-1}^2)/r_nr^2, inner/outer rows flat
    # nst/nz, volume zones by energy fraction. (The reference only
    # allocates surface photons where tbb<0 — it was run with file
    # boundaries only; we also source thermal boundaries with erin > 0.)
    area_frac_l = area_lower / jnp.sum(area_lower)
    area_frac_u = area_upper / jnp.sum(area_upper)
    n_l = jnp.where(erin_l > 0.0, (nst * area_frac_l).astype(jnp.int32), 0)
    n_u = jnp.where(erin_u > 0.0, (nst * area_frac_u).astype(jnp.int32), 0)
    n_i = jnp.where(erin_i > 0.0, jnp.int32(nst // nz), 0)
    n_o = jnp.where(erin_o > 0.0, jnp.int32(nst // nz), 0)
    n_v = (0.5 * nst * fas / emiss_tot).astype(jnp.int32).reshape(-1)

    counts = jnp.concatenate([n_v, n_l, n_u, n_i, n_o])
    n_new = jnp.sum(counts)
    # bias clamp (imcgen2d.f:491-517)
    fbias = jnp.where(
        n_new > bias_cap * nst, bias_cap * nst / jnp.maximum(n_new, 1), 1.0
    )
    counts = (counts * fbias).astype(jnp.int32)
    n_new = jnp.sum(counts)

    energies = jnp.concatenate(
        [fas.reshape(-1), erin_l, erin_u, erin_i, erin_o]
    )
    # under a device mesh every device runs this same budget with the
    # per-device nst; weights divide by the GLOBAL photon count so the
    # summed emission matches the energy budget
    weights = jnp.where(
        counts > 0,
        energies.astype(f32) / jnp.maximum(counts * replicas, 1),
        0.0,
    ).astype(jnp.float32)

    return SourceBudget(
        counts=counts,
        cum_counts=jnp.cumsum(counts),
        weights=weights,
        n_new=n_new,
        erin_lower=erin_l, erin_upper=erin_u,
        erin_inner=erin_i, erin_outer=erin_o,
        bingo=bingo,
    )



def _take1(vec, idx):
    """vec[idx] for per-photon int idx via an (n, m) @ (m,) one-hot
    matvec over the small per-zone/per-category vectors here."""
    m = vec.shape[0]
    oh = (
        idx[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, m), 1)
    ).astype(jnp.float32)
    return jnp.dot(
        oh, vec.astype(jnp.float32), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )

def emit(
    photons: PhotonArray,
    key: jax.Array,
    budget: SourceBudget,
    src: SourceStatic,
    grid_r_edges: jnp.ndarray,     # (nr+1,) f64
    grid_z_edges: jnp.ndarray,     # (nz+1,) f64
    zone_surf: jnp.ndarray,        # (nz, nr)
    eps_tot: jnp.ndarray,          # (nz, nr, n_vol) CDF
    eps_th: jnp.ndarray,           # (nz, nr, n_vol) CDF
    eloss_th: jnp.ndarray,         # (nz, nr)
    eloss_tot: jnp.ndarray,        # (nz, nr)
    e_ph: jnp.ndarray,             # (n_vol,)
    dt: jnp.ndarray,
    nz: int, nr: int,
    c_scaled: float = cn.C_LIGHT,  # speed of light [L/s]
    beam_mu: float = 0.99999999,
) -> PhotonArray:
    """Fill free slots with freshly emitted photons."""
    n = photons.n_slots
    nzr = nz * nr

    free = ~photons.alive
    rank = jnp.cumsum(free.astype(jnp.int32)) - 1       # rank among free
    is_new = free & (rank < budget.n_new)
    # category for this slot's photon
    # compare-count form of searchsorted(side='right')
    cat = jnp.sum(
        (budget.cum_counts[None, :] <= rank[:, None]).astype(jnp.int32),
        axis=1,
    )
    cat = jnp.clip(cat, 0, budget.cum_counts.shape[0] - 1)

    # category decomposition
    is_vol = cat < nzr
    c_l = cat - nzr
    is_low = (c_l >= 0) & (c_l < nr)
    c_u = c_l - nr
    is_up = (c_u >= 0) & (c_u < nr)
    c_i = c_u - nr
    is_in = (c_i >= 0) & (c_i < nz)
    c_o = c_i - nz
    is_out = (c_o >= 0) & (c_o < nz)

    jz_v = jnp.clip(cat // nr, 0, nz - 1)
    kr_v = jnp.clip(cat % nr, 0, nr - 1)
    kr_s = jnp.clip(jnp.where(is_low, c_l, c_u), 0, nr - 1)
    jz_s = jnp.clip(jnp.where(is_in, c_i, c_o), 0, nz - 1)

    jz = jnp.where(is_vol, jz_v, jnp.where(is_low, 0, jnp.where(
        is_up, nz - 1, jz_s))).astype(jnp.int32)
    kr = jnp.where(is_vol, kr_v, jnp.where(
        is_in, 0, jnp.where(is_out, nr - 1, kr_s))).astype(jnp.int32)

    keys = jax.random.split(key, 12)
    u = [
        jax.random.uniform(k, (n,), jnp.float32, 1e-7, 1.0) for k in keys
    ]

    re = grid_r_edges.astype(jnp.float32)
    ze = grid_z_edges.astype(jnp.float32)
    r_in = _take1(re, kr)
    r_out = _take1(re, kr + 1)
    z_bot = _take1(ze, jz)
    z_top = _take1(ze, jz + 1)

    # ---------------- positions -------------------------------------
    # uniform-in-annulus radius (imcvol2d_para.f: r = sqrt(r0^2+psi dr2))
    r_ann = jnp.sqrt(r_in**2 + u[0] * (r_out**2 - r_in**2))
    z_unif = z_bot + u[1] * (z_top - z_bot)

    # volume: thermal face split (vol_calc, imcvol2d_para.f:120-160)
    f_th = _take1(
        (eloss_th / jnp.maximum(eloss_tot, 1e-30)).reshape(-1),
        jnp.clip(cat, 0, nzr - 1),
    )
    thermal = is_vol & (u[2] < f_th)
    # face selection by area fraction
    dz_z = z_top - z_bot
    a_in = 2.0 * jnp.pi * r_in * dz_z
    a_out = 2.0 * jnp.pi * r_out * dz_z
    a_ud = jnp.pi * (r_out**2 - r_in**2)
    a_tot = a_in + a_out + 2.0 * a_ud
    c1 = a_in / a_tot
    c2 = c1 + a_out / a_tot
    c3 = c2 + a_ud / a_tot
    face = jnp.where(
        u[3] < c1, 0, jnp.where(u[3] < c2, 1, jnp.where(u[3] < c3, 2, 3))
    )  # 0 inner,1 outer,2 upper,3 lower

    # ---------------- directions ------------------------------------
    mu_iso = 2.0 * u[4] - 1.0
    phi_full = 2.0 * jnp.pi * (u[5] - 0.5)
    # outward half-space (cphi > 0): phi in (-pi/2, pi/2)
    phi_outw = jnp.pi * (u[5] - 0.5)
    # inward: phi in (pi/2, 3pi/2)
    phi_inw = jnp.pi * (u[5] - 0.5) + jnp.pi

    # volume photon defaults: interior, isotropic
    r_v = r_ann
    z_v = z_unif
    mu_v = mu_iso
    phi_v = phi_full
    # thermal face overrides
    r_v = jnp.where(
        thermal & (face == 0), r_in * 1.00001,
        jnp.where(thermal & (face == 1), r_out * 0.999999, r_v),
    )
    z_v = jnp.where(
        thermal & (face == 2), z_top * 0.999999,
        jnp.where(thermal & (face == 3), z_bot + 1e-6 * dz_z, z_v),
    )
    mu_v = jnp.where(
        thermal & (face == 2), u[6],
        jnp.where(thermal & (face == 3), -u[6], mu_v),
    )
    phi_v = jnp.where(
        thermal & (face == 0), phi_inw,
        jnp.where(thermal & (face == 1), phi_outw, phi_v),
    )

    # boundary sources (z_surf_calc / r_surf_calc)
    tbb_here = jnp.where(
        is_low, src.tbb_lower[kr_s],
        jnp.where(
            is_up, src.tbb_upper[kr_s],
            jnp.where(
                is_in, src.tbb_inner[jz_s], src.tbb_outer[jz_s]
            ),
        ),
    ).astype(jnp.float32)
    is_file = tbb_here < 0.0

    r_b = jnp.where(is_in, re[0], jnp.where(is_out, re[nr], r_ann))
    z_b = jnp.where(is_low, 0.0, jnp.where(is_up, ze[nz], z_unif))
    # lower: beamed up for file/external, isotropic-up for thermal
    mu_low = jnp.where(is_file, jnp.float32(beam_mu), u[6])
    mu_b = jnp.where(
        is_low, mu_low, jnp.where(is_up, -u[6], mu_iso)
    )
    phi_b = jnp.where(
        is_in, phi_outw, jnp.where(is_out, phi_inw, phi_full)
    )

    is_surf = is_low | is_up | is_in | is_out
    r_new = jnp.where(is_vol, r_v, r_b)
    z_new = jnp.where(is_vol, z_v, z_b)
    mu_new = jnp.clip(
        jnp.where(is_vol, mu_v, mu_b), -0.99999999, 0.99999999
    )
    phi_new = jnp.where(is_vol, phi_v, phi_b)

    # ---------------- energies --------------------------------------
    # volume: inverse-CDF over eps_tot / eps_th (imcvol2d_para.f:166-301).
    # Per-photon CDF rows come via a one-hot matmul over the stacked
    # [eps_tot; eps_th] table, (n, 2*nzr) @ (2*nzr, n_vol), in place
    # of a per-photon row gather of n x n_vol elements.
    n_vol = e_ph.shape[0]
    eps_stack = jnp.concatenate(
        [eps_tot.reshape(nzr, -1), eps_th.reshape(nzr, -1)], axis=0
    ).astype(jnp.float32)
    row_id = jnp.clip(cat, 0, nzr - 1) + jnp.where(thermal, nzr, 0)
    oh_row = (
        row_id[:, None]
        == jax.lax.broadcasted_iota(jnp.int32, (1, 2 * nzr), 1)
    ).astype(jnp.float32)
    cdf_v = jnp.dot(
        oh_row, eps_stack, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )
    iv = jnp.sum(
        (cdf_v < u[7][:, None]).astype(jnp.int32), axis=1
    )
    iv = jnp.clip(iv, 0, n_vol - 1)
    # bin-edge lookups in closed form: e_ph is log-uniform (the
    # emissivity pass already relies on the single ratio), so
    # e_ph[i] = e_ph[0] * ratio^i — two exp()s replace two (n, n_vol)
    # one-hot matmuls
    e_ph32 = e_ph.astype(jnp.float32)
    log_e0 = jnp.log(e_ph32[0])
    dlog_e = jnp.log(e_ph32[1] / e_ph32[0])
    e_hi = jnp.exp(log_e0 + iv.astype(jnp.float32) * dlog_e)
    e_lo = jnp.exp(
        log_e0 + jnp.maximum(iv - 1, 0).astype(jnp.float32) * dlog_e
    )
    e_v = e_lo + u[8] * (e_hi - e_lo)

    # boundary thermal: Planck at tbb (planck2d.f)
    e_planck = sample_planck(
        keys[9], jnp.maximum(tbb_here, 1e-6), dtype=jnp.float32
    )
    # boundary file spectrum (file_sample, imcsurf2d_para.f:694-788):
    # one lerp into the host-precomputed log-e quantile table. A bank
    # with only the dummy row (spec_e.shape[0] == 1, a STATIC shape
    # check) means no boundary anywhere uses a file spectrum, so the
    # sampler and its per-photon gathers are skipped entirely.
    if src.spec_e.shape[0] > 1:
        sid = jnp.where(
            is_low, src.spec_lower[kr_s], src.spec_upper[kr_s]
        ).astype(jnp.int32)
        m_inv = src.spec_inv.shape[1]
        x = u[10] * (m_inv - 1)
        j_q = jnp.clip(x.astype(jnp.int32), 0, m_inv - 2)
        fr = x - j_q.astype(jnp.float32)
        le_lo = src.spec_inv[sid, j_q]
        le_hi = src.spec_inv[sid, j_q + 1]
        e_file = jnp.exp(le_lo + fr * (le_hi - le_lo)).astype(jnp.float32)
        e_b = jnp.where(is_file, e_file, e_planck)
    else:
        e_b = e_planck
    e_new = jnp.where(is_vol, e_v, e_b)

    w_new = _take1(budget.weights, cat)
    dcen_new = (u[11] * jnp.float32(c_scaled)) * dt.astype(jnp.float32)

    # source energy lost when free slots run out (the reference instead
    # hard-stops at census overflow, imctrk2d.f:573-577)
    n_free = jnp.sum(free.astype(jnp.int32)).astype(jnp.int32)
    unplaced = jnp.clip(
        budget.cum_counts - n_free, 0, budget.counts
    )
    e_lost = jnp.sum(unplaced * budget.weights)

    photons = photons._replace(
        e=jnp.where(is_new, e_new, photons.e),
        w=jnp.where(is_new, w_new, photons.w),
        w0=jnp.where(is_new, w_new, photons.w0),
        r=jnp.where(is_new, r_new, photons.r),
        z=jnp.where(is_new, z_new, photons.z),
        mu=jnp.where(is_new, mu_new, photons.mu),
        cphi=jnp.where(is_new, jnp.cos(phi_new), photons.cphi),
        sphi=jnp.where(is_new, jnp.sin(phi_new), photons.sphi),
        dcen=jnp.where(is_new, dcen_new, photons.dcen),
        jz=jnp.where(is_new, jz, photons.jz),
        kr=jnp.where(is_new, kr, photons.kr),
        alive=photons.alive | is_new,
    )
    return photons, e_lost
