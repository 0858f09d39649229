"""The photon-tracking flight loop, vectorized over all photon slots.

Re-implements the reference's recursive per-photon tracker + boundary
handler (``/root/reference/src/imctrk2d.f``, ``imcleak2d.f``) as a single
lock-step masked ``while_loop`` over the photon SoA:

per iteration, every in-flight photon
  1. draws an optical depth and looks up its zone's macroscopic Compton
     cross section from the per-step (zones x n_vol) table (replacing the
     per-photon 200-term integral + memo cache of imctrk2d.f:170-187);
  2. computes the distance to its zone boundary (cylindrical geometry);
  3. takes the nearest event: census (ran out of time step), collision,
     or boundary crossing (imctrk2d.f:216-379);
  4. attenuates continuously (synchrotron self-absorption + gamma-gamma),
     depositing energy/pressure (imctrk2d.f:382-462);
  5. executes the event: zone hop / leak (escape, reflection, event
     record) / Compton scatter (in-loop, so multiply-scattered photons
     keep flying) / census (goes inactive, stays in the buffer).

Differences from the reference (deliberate):

- the three-level in-flight splitting (imctrk2d.f:105-661) is replaced by
  source-side replication (config ``split``) — the reference's det_src
  variant runs split1=1, establishing physics equivalence;
- census tallies (ecens/npcen/n_field/n_ph, imctrk2d.f:528-556) are made
  in one vectorized pass after the loop over surviving photons;
- RNG is counter-based: every (step, iteration) gets an independent
  threefry key, so results are independent of slot order and device
  count.

Weight-kill: photons below ``weight_floor * birth_weight`` die, their
energy tallied to ``e_killed`` (imctrk2d.f:81-91,465 kills silently).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from compton2d_tpu import constants as cn
from compton2d_tpu.state import EventBuffer, PhotonArray, Tallies
from compton2d_tpu.transport import geometry as geo
from compton2d_tpu.transport.scatter import scatter, scatter_stratified


@dataclass(frozen=True)
class TrackStatics:
    """Python-static configuration closed over by the jitted loop."""

    nz: int
    nr: int
    cr_sent: int = 0
    pair_switch: int = 0
    rmin_positive: bool = False
    max_iters: int = 512
    max_scatter_tries: int = 64
    weight_floor: float = 1.0e-10
    upper_escape_mu_cut: float = 0.98   # imcleak2d.f:303 event filter
    spec_switch: int = 0                # imcleak2d.f:53-58
    # stratified tail splitting (SourceConfig.strat_split; the vectorized
    # replacement for imctrk2d.f:593-661 split2/spl3)
    strat_split: bool = False
    strat_icut: int = 0                 # gnt index of the tail boundary
    strat_p_min: float = 1.0e-6
    strat_p_max: float = 0.5
    strat_copies: int = 1               # tail sub-strata per scatter
    # staged-compaction schedule: full width for phase0_iters, then
    # width n/div for the paired iteration budget, remainder at the
    # narrowest width (see transport_step docstring). Off by default:
    # the argsort/gather/scatter overhead has to beat the tail savings
    # of the early-exit full-width loop, which is not measured yet.
    use_compaction: bool = False
    phase0_iters: int = 16
    phase_divisors: Tuple[int, ...] = (4, 16)
    phase_iters: Tuple[int, ...] = (48, 10_000)


class TrackContext(NamedTuple):
    """Per-step device inputs for the tracker."""

    r_edges: jnp.ndarray       # (nr+1,) f32
    z_edges: jnp.ndarray       # (nz+1,) f32
    opac_zone: jnp.ndarray     # (nz*nr, n_vol, 2) f32 [scattering,
                               # absorption] opacities [1/L], stacked so
                               # the flight loop gathers them together
    kgg_zone: jnp.ndarray      # (nz*nr, n_gg) f32 gamma-gamma [1/cm]
    cdf_nt: jnp.ndarray        # (nz*nr, num_nt) f32 electron CDFs
    gnt: jnp.ndarray           # (num_nt,)
    e_ph_log0: jnp.ndarray     # () log of first e_ph grid point
    e_ph_dlog: jnp.ndarray     # () log spacing
    e_gg_log0: jnp.ndarray
    e_gg_dlog: jnp.ndarray
    e_field_log0: jnp.ndarray
    e_field_dlog: jnp.ndarray
    hu: jnp.ndarray            # (nphtotal+1,) spectral edges
    mu_edges: jnp.ndarray      # (nmu,)
    lc_lo: jnp.ndarray         # (nph_lc,)
    lc_hi: jnp.ndarray
    e_ref: jnp.ndarray         # (n_ref,)
    p_ref_t: jnp.ndarray       # (n_ref_in, n_ref_out) = P_ref transposed
    w_abs_t: jnp.ndarray       # (n_ref_in, n_ref_out)
    tbbl_pos: jnp.ndarray      # (nr,) bool: lower bnd thermal this window
    inv_nsigt: jnp.ndarray     # (nz*nr,) 1/(n_eff sigma_T L) for the
                               # stratified-scatter normalizer
    time: jnp.ndarray          # () f32 [s]
    dt: jnp.ndarray            # () f32 [s]
    inv_c: jnp.ndarray         # () f32 seconds per scaled length (L/c)


def _loggrid_interp(table, zid, e, log0, dlog):
    """Log-linear interpolation of per-zone tables: table (nzones, n_e)
    or (nzones, n_e, k) for k channels sharing the same energy grid;
    photon energies e (n,), zone ids zid (n,)."""
    n_e = table.shape[1]
    x = (jnp.log(jnp.maximum(e, 1e-30)) - log0) / dlog
    x = jnp.clip(x, 0.0, n_e - 1.000001)
    i0 = jnp.floor(x).astype(jnp.int32)
    f = (x - i0).astype(table.dtype)
    v0 = table[zid, i0]
    v1 = table[zid, i0 + 1]
    if table.ndim == 3:
        f = f[:, None]
    return v0 * (1.0 - f) + v1 * f


def zone_accum(vals, zid, nzr):
    """Deterministic segment-sum of per-photon values into the (small)
    zone axis via a one-hot matmul (a fixed summation order, unlike an
    atomic scatter-add). ``vals``: (n,) or (n, k) channels; returns
    (nzr,) / (nzr, k).

    Precision.HIGHEST: at a reduced matmul precision (bf16 or TF32
    operands) the VALUE operand keeps ~3 significant digits per
    element, which degrades physics-bearing tallies to ~1e-3 relative;
    full-f32 passes keep the one-hot sum exact to f32 accumulation
    order."""
    oh = (
        zid[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, nzr), 1)
    ).astype(jnp.float32)
    if vals.ndim == 1:
        return jnp.einsum(
            "n,nz->z", vals, oh, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return jnp.einsum(
        "nk,nz->zk", vals, oh, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def hist2d_accum(vals, zid, nzr, bins, n_bins):
    """Deterministic 2-D histogram sum((zid, bins) <- vals) as a
    two-sided one-hot matmul: (n_bins, n) @ (n, nzr), both one-hots
    fused from iota-compares, in place of ``.at[zid, bins].add``.
    Precision.HIGHEST so the value operand is not truncated (see
    zone_accum)."""
    ohz = (
        zid[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, nzr), 1)
    ).astype(jnp.float32) * vals[:, None]
    ohb = (
        bins[:, None]
        == jax.lax.broadcasted_iota(jnp.int32, (1, n_bins), 1)
    ).astype(jnp.float32)
    return jax.lax.dot_general(
        ohz, ohb, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (nzr, n_bins)


def loggrid_bin(e, log0, dlog, n_bins):
    """Shared log-grid binning + in-range mask for the radiation-field
    and gamma-gamma census tallies (imctrk2d.f:537-556): bin index on
    the grid starting at exp(log0) with ratio exp(dlog); photons below
    one grid ratio under the first point are out of range (the
    reference's E > E_0^2/E_1 threshold)."""
    x = (jnp.log(jnp.maximum(e, 1e-30)) - log0) / dlog
    b = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_bins - 1)
    in_range = x > -1.0   # e > E_0^2 / E_1 in log space
    return b, in_range


def spectral_bin(hu, e):
    """Spectrum bin index, -1 if outside [hu_0, hu_N]
    (get_bin, imcleak2d.f:342-371), as a compare-count."""
    e_c = e.astype(hu.dtype)
    i = jnp.sum(
        (hu[None, :] < e_c[:, None]).astype(jnp.int32), axis=1
    ) - 1
    valid = (e > hu[0] * 1.000001) & (e < hu[-1] * 0.999999)
    return jnp.where(valid, jnp.clip(i, 0, hu.shape[0] - 2), -1).astype(
        jnp.int32
    )


def lc_bin(lc_lo, lc_hi, e):
    """First light-curve band containing e, -1 if none
    (imcleak2d.f:375-386)."""
    e64 = e.astype(lc_lo.dtype)
    m = (e64[:, None] > lc_lo[None, :]) & (e64[:, None] <= lc_hi[None, :])
    any_m = jnp.any(m, axis=1)
    first = jnp.argmax(m, axis=1).astype(jnp.int32)
    return jnp.where(any_m, first, -1)


def mu_bin(mu_edges, mu):
    """Angular bin: first n with mu <= mu_edges[n] (imcleak2d.f:390-398).
    Compare-count form of searchsorted(side='left')."""
    mu_c = mu.astype(mu_edges.dtype)
    i = jnp.sum(
        (mu_edges[None, :] < mu_c[:, None]).astype(jnp.int32), axis=1
    )
    return jnp.clip(i, 0, mu_edges.shape[0] - 1).astype(jnp.int32)


def transport_step(
    photons: PhotonArray,
    tallies: Tallies,
    events: EventBuffer,
    key: jax.Array,
    ctx: TrackContext,
    st: TrackStatics,
) -> Tuple[PhotonArray, Tallies, EventBuffer]:
    """Track every photon to its census time, escape, or absorption.

    Staged compaction: the lock-step loop runs at full width only while
    most photons are in flight; the long tail (multiply-scattered /
    diffusing photons, the reason the reference forces 3-level
    splitting) is gathered into successively narrower buffers so tail
    iterations don't pay full-width vector cost. Any photon still in
    flight when its stage's buffer is too small simply stays in the slot
    array and goes to census with its remaining flight time unspent
    (bounded time skew, energy exactly conserved — the analogue of the
    reference's census cutoff).
    """
    n = photons.n_slots
    it0 = jnp.int32(0)
    if not st.use_compaction:
        photons, tallies, events, it_fin = _flight_phase(
            photons, tallies, events, key, ctx, st, st.max_iters, it0
        )
        tallies = tallies._replace(
            trk_rounds=tallies.trk_rounds + it_fin
        )
        photons = photons._replace(
            dcen=jnp.where(photons.alive, 0.0, photons.dcen)
        )
        return photons, tallies, events
    # stage 0: full width
    i1 = min(st.phase0_iters, st.max_iters)
    photons, tallies, events, it0 = _flight_phase(
        photons, tallies, events, key, ctx, st, i1, it0
    )
    # narrowing stages
    for div, iters in zip(st.phase_divisors, st.phase_iters):
        width = max(n // div, 256)
        if width >= n:
            continue
        inflight = photons.alive & (photons.dcen > 0.0)
        order = jnp.argsort(~inflight, stable=True)       # active first
        sel = order[:width]
        sub = jax.tree_util.tree_map(lambda a: a[sel], photons)
        sub, tallies, events, it0 = _flight_phase(
            sub, tallies, events, key, ctx, st,
            min(iters, st.max_iters), it0,
        )
        photons = jax.tree_util.tree_map(
            lambda a, s: a.at[sel].set(s), photons, sub
        )

    # stragglers that exhausted the budget go to census as-is
    photons = photons._replace(
        dcen=jnp.where(photons.alive, 0.0, photons.dcen)
    )
    return photons, tallies, events


def _flight_phase(
    photons: PhotonArray,
    tallies: Tallies,
    events: EventBuffer,
    key: jax.Array,
    ctx: TrackContext,
    st: TrackStatics,
    max_iters: int,
    it0,
):
    """The lock-step flight loop at the width of ``photons``."""
    n = photons.n_slots

    def zone_id(jz, kr):
        return jnp.clip(jz, 0, st.nz - 1) * st.nr + jnp.clip(
            kr, 0, st.nr - 1
        )

    def body(carry):
        it, ph, tl, ev = carry
        kit = jax.random.fold_in(key, it)
        k_tau, k_absp, k_scat, k_refl1, k_refl2 = jax.random.split(kit, 5)

        act = ph.alive & (ph.dcen > 0.0)
        zid = zone_id(ph.jz, ph.kr)

        # --- 1. cross sections & optical depth draw ------------------
        # sigma and kappa share the e_ph grid: one stacked gather
        sk = _loggrid_interp(
            ctx.opac_zone, zid, ph.e, ctx.e_ph_log0, ctx.e_ph_dlog
        )
        sig_s = jnp.maximum(sk[:, 0], 1e-30)  # f32-normal floor
        kap = sk[:, 1]
        u_tau = jax.random.uniform(
            k_tau, (n,), jnp.float32, minval=1e-12, maxval=1.0
        )
        dcol = -jnp.log(u_tau) / sig_s

        # --- 2. geometry ---------------------------------------------
        g = geo.distance_to_boundary(
            ph.r, ph.z, ph.mu, ph.cphi, ph.sphi,
            jnp.clip(ph.jz, 0, st.nz - 1), jnp.clip(ph.kr, 0, st.nr - 1),
            ctx.r_edges, ctx.z_edges,
        )

        # --- 3. event selection (imctrk2d.f:216-379) -----------------
        trld = jnp.minimum(ph.dcen, dcol)
        ikind = jnp.where(ph.dcen <= dcol, 2, 3)
        hit_bnd = g.trldb < trld
        trld = jnp.where(hit_bnd, g.trldb, trld)
        ikind = jnp.where(hit_bnd, 1, ikind)

        # --- 4. continuous absorption (imctrk2d.f:382-462) -----------
        if st.pair_switch:
            kgg = _loggrid_interp(
                ctx.kgg_zone, zid, ph.e, ctx.e_gg_log0, ctx.e_gg_dlog
            )
            kgg = jnp.where(
                ph.e > jnp.exp(ctx.e_gg_log0), kgg,
                kgg * ph.e / jnp.exp(ctx.e_gg_log0).astype(jnp.float32),
            )
        else:
            kgg = jnp.zeros_like(kap)
        # floor must stay in f32 normal range: 1e-40 is subnormal and
        # flushes to zero, making frac_heat below 0/0 = NaN
        sigabs = jnp.maximum(kap + kgg, 1e-30)
        xabs = sigabs * trld
        ewnew = jnp.where(xabs < 100.0, ph.w * jnp.exp(-xabs), 0.0)
        deleabs = jnp.maximum(ph.w - ewnew, 0.0)
        # gamma-gamma absorbed energy above 47 keV becomes pairs, not
        # heat (imctrk2d.f:429-434); sigabs - kgg == kap exactly
        if st.pair_switch:
            frac_heat = jnp.where(ph.e > 47.0, kap / sigabs, 1.0)
            # the gamma-gamma-absorbed remainder becomes pairs, not
            # heat: tally it so the photon-side audit closes
            tl = tl._replace(
                e_pair_abs=tl.e_pair_abs + jnp.sum(
                    jnp.where(act, deleabs * (1.0 - frac_heat), 0.0)
                )
            )
        else:
            frac_heat = jnp.ones_like(sigabs)
        edep_add = jnp.where(act, deleabs * frac_heat, 0.0)
        # pressure deposit with sampled absorption depth
        # (imctrk2d.f:440-457)
        u_s = jax.random.uniform(k_absp, (n,), jnp.float32, 1e-7, 1.0)
        tiny_abs = xabs <= 1e-5
        frac = jnp.clip(-jnp.expm1(-xabs) * u_s, 0.0, 0.999999)
        sstar = jnp.where(
            tiny_abs, 0.5 * trld, -jnp.log1p(-frac) / sigabs
        )
        denom = jnp.sqrt(
            jnp.maximum(
                ph.r**2 + 2.0 * ph.mu * ph.r * sstar + sstar**2, 1e-20
            )
        )
        wmustar = jnp.where(
            tiny_abs, ph.mu, (ph.mu * ph.r + sstar) / denom
        )
        prdep_add = jnp.where(
            act, deleabs * wmustar * jnp.float32(cn.C_LIGHT), 0.0
        )
        dep2 = zone_accum(
            jnp.stack([edep_add, prdep_add], axis=1), zid,
            st.nz * st.nr,
        )
        tl = tl._replace(
            edep=(tl.edep.reshape(-1) + dep2[:, 0]).reshape(
                st.nz, st.nr
            ),
            prdep=(tl.prdep.reshape(-1) + dep2[:, 1]).reshape(
                st.nz, st.nr
            ),
        )

        # --- weight floor kill (imctrk2d.f:465) ----------------------
        killed = act & (ewnew <= st.weight_floor * ph.w0)
        tl = tl._replace(
            e_killed=tl.e_killed + jnp.sum(jnp.where(killed, ewnew, 0.0))
        )

        # --- 5. move -------------------------------------------------
        # (geo.advance inlined so the boundary case can pin the exact
        # boundary coordinates, imctrk2d.f:365-379)
        on_bnd = act & (ikind == 1)
        f_h = trld * jnp.sqrt(jnp.maximum(1.0 - ph.mu**2, 0.0))
        r_free = jnp.sqrt(
            jnp.maximum(
                f_h**2 + ph.r**2 + 2.0 * f_h * ph.r * ph.cphi, 0.0
            )
        )
        rnew = jnp.where(on_bnd, g.rbnd, r_free)
        znew = jnp.where(on_bnd, g.zbnd, ph.z + trld * ph.mu)
        rs = jnp.maximum(rnew, 1e-20)
        cphi_n = jnp.clip((f_h + ph.cphi * ph.r) / rs, -1.0, 1.0)
        sphi_n = jnp.clip(ph.sphi * ph.r / rs, -1.0, 1.0)
        nrm = jnp.sqrt(jnp.maximum(cphi_n**2 + sphi_n**2, 1e-12))
        cphi_n, sphi_n = cphi_n / nrm, sphi_n / nrm

        upd = act & ~killed
        ph = ph._replace(
            w=jnp.where(act, jnp.where(killed, 0.0, ewnew), ph.w),
            r=jnp.where(upd, rnew, ph.r),
            z=jnp.where(upd, znew, ph.z),
            cphi=jnp.where(upd, cphi_n, ph.cphi),
            sphi=jnp.where(upd, sphi_n, ph.sphi),
            dcen=jnp.where(upd, ph.dcen - trld, ph.dcen),
            alive=ph.alive & ~killed,
        )

        # --- 6a. boundary crossings / leaks --------------------------
        cross = upd & (ikind == 1)
        in_dom = (
            (g.jnew >= 0) & (g.jnew < st.nz)
            & (g.knew >= 0) & (g.knew < st.nr)
        )
        ph = ph._replace(
            jz=jnp.where(cross & in_dom, g.jnew, ph.jz),
            kr=jnp.where(cross & in_dom, g.knew, ph.kr),
        )
        leak_mask = cross & ~in_dom
        ph, tl, ev = jax.lax.cond(
            jnp.any(leak_mask),
            lambda ph, tl, ev: _leak(
                ph, tl, ev, leak_mask, g, ctx, st, k_refl1, k_refl2
            ),
            lambda ph, tl, ev: (ph, tl, ev),
            ph, tl, ev,
        )

        # --- 6b. scattering (in-flight, imctrk2d.f:580-684) ----------
        # guarded by lax.cond: tail iterations (few in-flight photons,
        # none scattering) skip the CDF gather + rejection loops
        sct = upd & (ikind == 3) & ph.alive

        ph, tl = jax.lax.cond(
            jnp.any(sct),
            lambda ph, tl: apply_scatter(
                ph, tl, sct, zid, sig_s, k_scat, ctx, st
            ),
            lambda ph, tl: (ph, tl),
            ph, tl,
        )

        return it + 1, ph, tl, ev

    it_end = it0 + max_iters

    def cond(carry):
        it, ph, _, _ = carry
        return (it < it_end) & jnp.any(ph.alive & (ph.dcen > 0.0))

    it_fin, photons, tallies, events = jax.lax.while_loop(
        cond, body, (it0, photons, tallies, events)
    )
    return photons, tallies, events, it_fin


def _zone_rows(table, zid, nzr):
    """Per-photon row lookup table[zid] as an (n, nzr) @ (nzr, k)
    one-hot matmul for small zone counts, and a plain row gather above
    256 zones, where the one-hot operand would dominate."""
    if table.shape[0] > 256:
        return table[zid]
    oh = (
        zid[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, nzr), 1)
    ).astype(table.dtype)
    return jnp.dot(oh, table, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)


def apply_scatter(ph, tl, sct, zid, sig_s, k_scat, ctx, st):
    """Execute Compton scatters for the masked photons (the ikind=3
    branch, imctrk2d.f:580-684) inside the flight loop. ``sig_s`` is
    each photon's current-zone
    scattering opacity (the stratified-splitting normalizer)."""
    n = ph.n_slots

    if st.strat_split:
        # stratified tail splitting (the unbiased analogue of the
        # split2/spl3 scheme, imctrk2d.f:593-661): the parent samples
        # the electron stratum below gamma_c; M = st.strat_copies
        # copies in free slots each sample an equal sub-stratum of the
        # tail [c, 1) with weight fraction p_tail/M (M > 1 is the
        # analogue of the reference's split3 resample count,
        # imctrk2d.f:629-661 — it multiplies the deep-KN tail
        # statistics per scattering event). Placement is
        # all-or-nothing per scatter so strata stay contiguous and
        # exactly unbiased when free slots run short.
        M = max(int(st.strat_copies), 1)
        cdf_rows = _zone_rows(ctx.cdf_nt, zid, st.nz * st.nr)
        c = cdf_rows[:, st.strat_icut]
        p_tail = jnp.clip(1.0 - c, 0.0, 1.0)
        want = (
            sct
            & (p_tail > st.strat_p_min)
            & (p_tail <= st.strat_p_max)
        )
        free = ~ph.alive
        cfree = jnp.cumsum(free.astype(jnp.int32))
        n_free = cfree[-1]
        rank = jnp.cumsum(want.astype(jnp.int32)) - 1
        placed = want & ((rank + 1) * M <= n_free)
        # index of the (r+1)-th free slot, r < n_free: a scatter of
        # slot ids by free-rank + per-copy gathers, in place of a
        # searchsorted over the (n,)-sized cumulative count
        slot_of_rank = jnp.zeros((n,), jnp.int32).at[
            jnp.where(free, cfree - 1, n)
        ].set(jnp.arange(n, dtype=jnp.int32), mode="drop")

        # 1/Z with Z = <sigma_KN ratio> = sig_s/(n_eff sigT L)
        inv_z = 1.0 / jnp.maximum(
            sig_s * _zone_rows(ctx.inv_nsigt[:, None], zid, st.nz * st.nr)[:, 0], 1e-30
        )
        u_hi_par = jnp.where(placed, c, 1.0)
        res_p = scatter_stratified(
            k_scat, ph.e, ph.mu, ph.cphi, ph.sphi, cdf_rows,
            ctx.gnt, u_lo=jnp.zeros_like(c), u_hi=u_hi_par,
            inv_z=inv_z, max_tries=st.max_scatter_tries,
            need=sct,
        )
        # pre-scatter photon state: the tail copies scatter THIS
        # photon, not the parent's post-scatter state
        w_parent = ph.w
        e_pre, mu_pre = ph.e, ph.mu
        cphi_pre, sphi_pre = ph.cphi, ph.sphi
        w_pre_p = jnp.where(placed, ph.w * (1.0 - p_tail), ph.w)
        w_new_p = w_pre_p * res_p.wscale
        d_e_p = jnp.where(sct, w_new_p - w_pre_p, 0.0)
        tl = tl._replace(
            edep=(
                tl.edep.reshape(-1)
                + zone_accum(d_e_p, zid, st.nz * st.nr)
            ).reshape(st.nz, st.nr),
            e_ic=tl.e_ic
            + zone_accum(d_e_p, res_p.i_gam, tl.e_ic.shape[0]),
            n_esp=tl.n_esp
            + zone_accum(jnp.where(sct, 1.0, 0.0), res_p.i_gam,
                         tl.n_esp.shape[0]),
            e_scatter=tl.e_scatter + jnp.sum(d_e_p),
        )
        ph = ph._replace(
            e=jnp.where(sct, res_p.e, ph.e),
            w=jnp.where(sct, w_new_p, ph.w),
            mu=jnp.where(sct, res_p.mu, ph.mu),
            cphi=jnp.where(sct, res_p.cphi, ph.cphi),
            sphi=jnp.where(sct, res_p.sphi, ph.sphi),
        )

        inv_m = 1.0 / jnp.float32(M)
        for m in range(M):
            u_lo_m = c + (1.0 - c) * (m * 1.0 / M)
            u_hi_m = (
                jnp.ones_like(c) if m == M - 1
                else c + (1.0 - c) * ((m + 1.0) / M)
            )
            res_c = scatter_stratified(
                jax.random.fold_in(k_scat, 1 + m), e_pre, mu_pre,
                cphi_pre, sphi_pre, cdf_rows, ctx.gnt,
                u_lo=u_lo_m, u_hi=u_hi_m, inv_z=inv_z,
                max_tries=st.max_scatter_tries, need=placed,
            )
            w_pre_c = w_parent * p_tail * inv_m
            w_new_c = w_pre_c * res_c.wscale
            d_e_c = jnp.where(placed, w_new_c - w_pre_c, 0.0)
            tl = tl._replace(
                edep=(
                    tl.edep.reshape(-1)
                    + zone_accum(d_e_c, zid, st.nz * st.nr)
                ).reshape(st.nz, st.nr),
                e_ic=tl.e_ic
                + zone_accum(d_e_c, res_c.i_gam, tl.e_ic.shape[0]),
                n_esp=tl.n_esp + zone_accum(
                    jnp.where(placed, 1.0, 0.0), res_c.i_gam,
                    tl.n_esp.shape[0],
                ),
                e_scatter=tl.e_scatter + jnp.sum(d_e_c),
            )
            slot_w = jnp.where(
                placed,
                slot_of_rank[jnp.clip(rank * M + m, 0, n - 1)],
                n,
            )

            def put(arr, vals):
                return arr.at[slot_w].set(vals, mode="drop")

            ph = ph._replace(
                e=put(ph.e, res_c.e),
                w=put(ph.w, w_new_c),
                w0=put(ph.w0, jnp.maximum(w_new_c, 1e-30)),
                r=put(ph.r, ph.r),
                z=put(ph.z, ph.z),
                mu=put(ph.mu, res_c.mu),
                cphi=put(ph.cphi, res_c.cphi),
                sphi=put(ph.sphi, res_c.sphi),
                dcen=put(ph.dcen, ph.dcen),
                jz=put(ph.jz, ph.jz),
                kr=put(ph.kr, ph.kr),
                alive=put(ph.alive, placed),
            )
        return ph, tl

    cdf_rows = _zone_rows(ctx.cdf_nt, zid, st.nz * st.nr)
    res = scatter(
        k_scat, ph.e, ph.mu, ph.cphi, ph.sphi, cdf_rows,
        ctx.gnt, max_tries=st.max_scatter_tries, need=sct,
    )
    w_old = ph.w
    w_new = ph.w * res.wscale
    d_e = jnp.where(sct, w_new - w_old, 0.0)
    tl = tl._replace(
        edep=(
            tl.edep.reshape(-1)
            + zone_accum(d_e, zid, st.nz * st.nr)
        ).reshape(st.nz, st.nr),
        e_ic=tl.e_ic + zone_accum(d_e, res.i_gam, tl.e_ic.shape[0]),
        n_esp=tl.n_esp + zone_accum(
            jnp.where(sct, 1.0, 0.0), res.i_gam, tl.n_esp.shape[0]
        ),
        e_scatter=tl.e_scatter + jnp.sum(d_e),
    )
    ph = ph._replace(
        e=jnp.where(sct, res.e, ph.e),
        w=jnp.where(sct, w_new, ph.w),
        mu=jnp.where(sct, res.mu, ph.mu),
        cphi=jnp.where(sct, res.cphi, ph.cphi),
        sphi=jnp.where(sct, res.sphi, ph.sphi),
    )
    return ph, tl


def _leak(ph, tl, ev, mask, g, ctx, st, k1, k2):
    """Boundary handler (imcleak2d.f): escapes, reflection, axis."""
    n = ph.n_slots
    at_inner = mask & (g.knew < 0)
    at_outer = mask & (g.knew >= st.nr)
    at_lower = mask & (g.jnew < 0) & ~at_inner & ~at_outer
    at_upper = mask & (g.jnew >= st.nz) & ~at_inner & ~at_outer

    jz_c = jnp.clip(ph.jz, 0, st.nz - 1)
    kr_c = jnp.clip(ph.kr, 0, st.nr - 1)

    # inner r boundary (imcleak2d.f:71-88)
    if st.rmin_positive:
        tl = tl._replace(
            erlk_inner=tl.erlk_inner + zone_accum(
                jnp.where(at_inner, ph.w, 0.0), jz_c, st.nz
            )
        )
        die_inner = at_inner
    else:
        # transparent axis: point outward, stay in zone 0
        ph = ph._replace(
            cphi=jnp.where(at_inner, 1.0, ph.cphi),
            sphi=jnp.where(at_inner, 1e-6, ph.sphi),
            kr=jnp.where(at_inner, 0, ph.kr),
        )
        die_inner = jnp.zeros((n,), bool)

    # leakage tallies (deterministic one-hot matmul accums)
    tl = tl._replace(
        erlk_outer=tl.erlk_outer + zone_accum(
            jnp.where(at_outer, ph.w, 0.0), jz_c, st.nz
        ),
        erlk_upper=tl.erlk_upper + zone_accum(
            jnp.where(at_upper, ph.w, 0.0), kr_c, st.nr
        ),
        erlk_lower=tl.erlk_lower + zone_accum(
            jnp.where(at_lower, ph.w, 0.0), kr_c, st.nr
        ),
        ed_in=tl.ed_in + zone_accum(
            jnp.where(at_lower & ctx.tbbl_pos[kr_c], ph.w, 0.0),
            kr_c, st.nr,
        ),
    )

    # --- Compton reflection sampling shared by the lower boundary and
    # the outer disk (imcleak2d.f:104-165, 216-272)
    def sample_reflection(e_in, w_in, k_cdf, k_e):
        n_ref = ctx.e_ref.shape[0]
        # compare-count form of searchsorted
        n_in = jnp.clip(
            jnp.sum(
                (
                    ctx.e_ref[None, :]
                    < e_in.astype(ctx.e_ref.dtype)[:, None]
                ).astype(jnp.int32),
                axis=1,
            ),
            0, n_ref - 1,
        ).astype(jnp.int32)
        u = jax.random.uniform(k_cdf, (n,), jnp.float32)
        # per-photon binary search down the P_ref column: O(log n_ref)
        # scalar gathers instead of an (n, n_ref) row gather
        lo = jnp.zeros((n,), jnp.int32)
        hi = jnp.full((n,), n_ref, jnp.int32)
        n_bits = int(np.ceil(np.log2(max(n_ref, 2))))
        for _ in range(n_bits):
            mid = (lo + hi) // 2
            v = ctx.p_ref_t[n_in, jnp.clip(mid, 0, n_ref - 1)]
            go_hi = v < u
            lo = jnp.where(go_hi, mid + 1, lo)
            hi = jnp.where(go_hi, hi, mid)
        n_out = jnp.clip(lo, 0, n_ref - 1)
        u2 = jax.random.uniform(k_e, (n,), jnp.float32)
        e_lo = ctx.e_ref[jnp.maximum(n_out - 1, 0)]
        e_hi = ctx.e_ref[n_out]
        e_new = jnp.where(
            n_out > 0, e_lo + u2 * (e_hi - e_lo), ctx.e_ref[0]
        ).astype(jnp.float32)
        w_fac = ctx.w_abs_t[n_in, n_out].astype(jnp.float32)
        w_new = w_in * w_fac * e_new / jnp.maximum(e_in, 1e-30)
        return e_new, w_new

    # --- lower-boundary Compton reflection (imcleak2d.f:104-165) -----
    reflect_low = jnp.zeros((n,), bool)
    if st.cr_sent in (1, 3, 4):
        reflect_low = at_lower
        mirror = ~ctx.tbbl_pos[kr_c] | (st.cr_sent == 4)
        refl_sample = reflect_low & ~mirror
        e_new, w_new = sample_reflection(ph.e, ph.w, k1, k2)
        tl = tl._replace(
            ed_ref=tl.ed_ref + zone_accum(
                jnp.where(refl_sample, w_new, 0.0), kr_c, st.nr
            )
        )
        ph = ph._replace(
            e=jnp.where(refl_sample, e_new, ph.e),
            w=jnp.where(refl_sample, w_new, ph.w),
            mu=jnp.where(reflect_low, jnp.abs(ph.mu), ph.mu),
            jz=jnp.where(reflect_low, 0, ph.jz),
        )

    # --- outer-disk reflection (cr_sent 2/3, imcleak2d.f:216-272):
    # downward-moving photons leaving the outer radius reflect off the
    # surrounding disk; the reflected photon is recorded as an escape
    # with a time-of-flight delay to the disk plane and killed ---------
    if st.cr_sent in (2, 3):
        disk_refl = at_outer & (ph.mu <= 0.0)
        k3 = jax.random.fold_in(k1, 1)
        k4 = jax.random.fold_in(k2, 1)
        e_new, w_new = sample_reflection(ph.e, ph.w, k3, k4)
        mu_ok = jnp.abs(ph.mu) > 1e-6
        # flight to the z=0 disk plane (imcleak2d.f:247-255)
        extra_t = jnp.where(
            mu_ok, ph.z / jnp.maximum(jnp.abs(ph.mu), 1e-6), 1e20
        )
        f_h = ph.z * jnp.sqrt(
            jnp.maximum(1.0 - ph.mu**2, 0.0)
        ) / jnp.maximum(jnp.abs(ph.mu), 1e-6)
        r_disk = jnp.sqrt(
            jnp.maximum(
                ph.r**2 + f_h**2 + 2.0 * ph.r * f_h * ph.cphi, 0.0
            )
        )
        u_mu = jax.random.uniform(jax.random.fold_in(k1, 2), (n,),
                                  jnp.float32)
        ph = ph._replace(
            e=jnp.where(disk_refl, e_new, ph.e),
            w=jnp.where(disk_refl, w_new, ph.w),
            z=jnp.where(disk_refl, 0.0, ph.z),
            r=jnp.where(disk_refl & mu_ok, r_disk, ph.r),
            mu=jnp.where(disk_refl, u_mu, ph.mu),
        )
        disk_extra_t = jnp.where(disk_refl, extra_t, 0.0)
    else:
        disk_extra_t = jnp.zeros((n,), jnp.float32)

    # --- escapes ------------------------------------------------------
    esc_lower = at_lower & ~reflect_low
    esc_upper = at_upper
    escaping = at_outer | esc_lower | esc_upper | die_inner

    # absorbed-at-inner-boundary photons are not escapes: no event record
    record = (at_outer | esc_lower | esc_upper) & ~(
        esc_upper & (ph.mu >= st.upper_escape_mu_cut)
    )
    # time of flight remaining: dcen [L] * (L/c) [s/L] (imcleak2d.f:203)
    # plus the disk-reflection flight delay (imcleak2d.f:247-249)
    t_bound = (
        ctx.time.astype(jnp.float32) + ctx.dt.astype(jnp.float32)
        - ctx.inv_c * (ph.dcen - disk_extra_t)
    )

    sp = spectral_bin(ctx.hu, ph.e)
    lc = lc_bin(ctx.lc_lo, ctx.lc_hi, ph.e)
    mb = mu_bin(ctx.mu_edges, ph.mu)
    w_tal = jnp.where(record, ph.w, 0.0)
    if st.spec_switch == 1:
        # spectra incident on the z boundaries (imcleak2d.f:116-117):
        # tally the reflected/at-boundary photons, not the escapes
        w_sp = jnp.where(reflect_low | at_upper | at_lower, ph.w, 0.0)
    else:
        w_sp = w_tal
    nmu = tl.fout.shape[0]
    tl = tl._replace(
        fout=tl.fout + hist2d_accum(
            jnp.where(sp >= 0, w_sp, 0.0), mb, nmu,
            jnp.maximum(sp, 0), tl.fout.shape[1],
        ),
        edout=tl.edout + hist2d_accum(
            jnp.where(lc >= 0, w_tal, 0.0) / ctx.dt, mb, nmu,
            jnp.maximum(lc, 0), tl.edout.shape[1],
        ),
    )

    # event records (imcleak2d.f:105 format)
    phi = jnp.arctan2(ph.sphi, ph.cphi)
    rec = jnp.stack(
        [t_bound, ph.e, ph.w, ph.r, ph.z, ph.mu, phi], axis=1
    )
    n_rec = jnp.sum(record.astype(jnp.int32)).astype(jnp.int32)
    idx = (
        ev.count + jnp.cumsum(record.astype(jnp.int32)).astype(jnp.int32)
        - 1
    )
    write = record & (idx < ev.data.shape[0])
    ev = ev._replace(
        data=ev.data.at[jnp.where(write, idx, ev.data.shape[0])].set(
            rec, mode="drop"
        ),
        count=(ev.count + n_rec).astype(jnp.int32),
    )

    ph = ph._replace(alive=ph.alive & ~(escaping | die_inner))
    return ph, tl, ev


def census_tally(
    photons: PhotonArray,
    tallies: Tallies,
    ctx: TrackContext,
    st: TrackStatics,
) -> Tallies:
    """Census tallies over the surviving photon population
    (imctrk2d.f:528-556), one vectorized pass after tracking.

    The radiation-field tallies are stored *scaled*:
    n_field = sum(w_scaled / E_keV); the FP solve converts to absolute
    photon counts with Scales.nfield_to_dgic (the reference stores
    6.25e8 * ew / xnu directly, imctrk2d.f:555)."""
    alive = photons.alive
    zid = (
        jnp.clip(photons.jz, 0, st.nz - 1) * st.nr
        + jnp.clip(photons.kr, 0, st.nr - 1)
    )
    w = jnp.where(alive, photons.w, 0.0)
    nzr = st.nz * st.nr

    cen2 = zone_accum(
        jnp.stack([w, jnp.where(alive, 1.0, 0.0)], axis=1), zid, nzr
    )
    ecens = tallies.ecens.reshape(-1) + cen2[:, 0]
    npcen = tallies.npcen.reshape(-1) + cen2[:, 1]

    counts = jnp.where(
        alive, w / jnp.maximum(photons.e, 1e-30), 0.0
    )
    # single source of truth for the field/gamma-gamma thresholds
    # (imctrk2d.f:537-556): loggrid_bin
    nphf = tallies.n_field.shape[-1]
    fbin, in_field = loggrid_bin(
        photons.e, ctx.e_field_log0, ctx.e_field_dlog, nphf
    )
    n_field = tallies.n_field.reshape(nzr, nphf) + hist2d_accum(
        jnp.where(in_field, counts, 0.0), zid, nzr, fbin, nphf
    )

    # gamma-gamma field (imctrk2d.f:537-545)
    ngg = tallies.n_ph.shape[-1]
    gbin, in_gg = loggrid_bin(
        photons.e, ctx.e_gg_log0, ctx.e_gg_dlog, ngg
    )
    n_ph = tallies.n_ph.reshape(nzr, ngg) + hist2d_accum(
        jnp.where(in_gg, counts, 0.0), zid, nzr, gbin, ngg
    )

    return tallies._replace(
        ecens=ecens.reshape(st.nz, st.nr),
        npcen=npcen.reshape(st.nz, st.nr),
        n_field=n_field.reshape(st.nz, st.nr, nphf),
        n_ph=n_ph.reshape(st.nz, st.nr, ngg),
    )
