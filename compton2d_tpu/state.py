"""Simulation state pytrees.

Replaces the reference's single global COMMON block
(``/root/reference/src/commonblock.f``) with explicit, functional state:

- :class:`ZoneState`  — per-zone prognostic fields (replicated across the
  device mesh; small enough that "broadcast" is free, SURVEY.md §2.7 P1);
- :class:`PhotonArray` — SoA photon slots (sharded over devices, P3);
- :class:`Tallies`    — per-step Monte-Carlo tallies, reduced with psum
  (P4);
- :class:`SimState`   — everything a step consumes/produces.

All photon fields are float32 (energy weights in units of
``RunConfig.energy_scale`` erg); zone physics fields are float32 too (see compton2d_tpu.units).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from compton2d_tpu.config import SimConfig


class ZoneState(NamedTuple):
    """Prognostic per-zone fields, shapes (nz, nr) / (nz, nr, num_nt)."""

    tea: jnp.ndarray        # electron temperature [keV]
    tna: jnp.ndarray        # proton temperature [keV]
    n_e: jnp.ndarray        # proton (≈electron) density [cm^-3]
    B_field: jnp.ndarray    # magnetic field [G]
    amxwl: jnp.ndarray      # Maxwellian fraction (initial-condition only)
    gmin: jnp.ndarray       # effective nonthermal low cutoff
    gmax: jnp.ndarray       # effective nonthermal high cutoff
    p_nth: jnp.ndarray      # effective nonthermal PL index
    q_turb: jnp.ndarray     # turbulence spectral index — carried for
                            # config parity; the *active* acceleration is
                            # hard-sphere (q = 2) so it does not enter the
                            # operator, matching update2d.f:1035-1037
                            # where the q-dependent terms are commented out
    turb_lev: jnp.ndarray   # turbulence level
    ep_switch: jnp.ndarray  # (nz, nr) int32
    f_nt: jnp.ndarray       # (nz, nr, num_nt) electron dist, unit integral
    cdf_nt: jnp.ndarray     # (nz, nr, num_nt) sampling CDF (Pnt)
    f_pair: jnp.ndarray     # positron fraction n+/n_p
    n_pos: jnp.ndarray      # (nz, nr, num_nt) positron distribution
    ec_old: jnp.ndarray     # census energy carried into the step [erg]


class PhotonArray(NamedTuple):
    """SoA photon slots, shape (n_slots,) each, float32/int32.

    Geometry convention (matches imctrk2d.f): ``mu`` is the direction
    cosine w.r.t. +z; (``cphi``, ``sphi``) are cos/sin of the azimuth of
    the horizontal direction *relative to the local outward radial
    direction* — the reference's (phi, Eta_switch) pair
    (imctrk2d.f:228-247) stored as a unit vector so no trig is needed in
    flight.
    """

    e: jnp.ndarray        # photon energy [keV] (xnu)
    w: jnp.ndarray        # energy weight [energy_scale erg] (ew)
    w0: jnp.ndarray       # birth weight (for the Russian-roulette floor)
    r: jnp.ndarray        # radius [cm]
    z: jnp.ndarray        # height [cm]
    mu: jnp.ndarray       # direction cosine to +z
    cphi: jnp.ndarray     # cos(azimuth rel. to outward radial)
    sphi: jnp.ndarray     # sin(azimuth rel. to outward radial)
    dcen: jnp.ndarray     # remaining distance to census [cm]
    jz: jnp.ndarray       # int32 zone z-index (0-based)
    kr: jnp.ndarray       # int32 zone r-index (0-based)
    alive: jnp.ndarray    # bool: occupied slot

    @property
    def n_slots(self) -> int:
        return self.e.shape[0]

    @classmethod
    def empty(cls, n_slots: int) -> "PhotonArray":
        # numpy host arrays: only built at init time (the first jitted
        # step converts them), instead of one eager device op per field
        import numpy as np

        # distinct buffers per field: aliasing one zero array across
        # fields would let a host-side in-place write to one silently
        # corrupt the others
        def zf():
            return np.zeros((n_slots,), np.float32)

        return cls(
            e=zf(), w=zf(), w0=zf(), r=zf(), z=zf(), mu=zf(),
            cphi=np.ones((n_slots,), np.float32), sphi=zf(),
            dcen=zf(), jz=np.zeros((n_slots,), np.int32),
            kr=np.zeros((n_slots,), np.int32),
            alive=np.zeros((n_slots,), bool),
        )


class Tallies(NamedTuple):
    """Per-step MC tallies (f32 accumulators, scaled units; commonblock.f:47-52,
    70-78, 108-109)."""

    edep: jnp.ndarray      # (nz, nr) absorbed+exchanged energy [erg]
    prdep: jnp.ndarray     # (nz, nr) radial momentum deposit
    ecens: jnp.ndarray     # (nz, nr) census energy [erg]
    npcen: jnp.ndarray     # (nz, nr) census photon counts
    n_field: jnp.ndarray   # (nz, nr, nphfield) photon number in field bins
    n_ph: jnp.ndarray      # (nz, nr, n_gg) gamma-gamma field photon counts
    e_ic: jnp.ndarray      # (num_nt,) IC energy exchange per electron bin
    n_esp: jnp.ndarray     # (num_nt,) electrons sampled per bin at
                           # scatters (the esp.dat histogram,
                           # xec2d.f:116-124 / nontherm2d.f nelectron)
    fout: jnp.ndarray      # (nmu, nphtotal) escaping spectrum [erg]
    edout: jnp.ndarray     # (nmu, nph_lc) escaping LC power [erg/s]
    erlk_inner: jnp.ndarray  # (nz,) leakage through inner r boundary
    erlk_outer: jnp.ndarray  # (nz,)
    erlk_upper: jnp.ndarray  # (nr,)
    erlk_lower: jnp.ndarray  # (nr,)
    ed_in: jnp.ndarray     # (nr,) energy incident on lower boundary
    ed_ref: jnp.ndarray    # (nr,) energy Compton-reflected at lower bnd
    e_killed: jnp.ndarray  # () energy lost to weight-floor kills
    e_scatter: jnp.ndarray  # () net photon energy gained from electrons
    e_pair_abs: jnp.ndarray  # () gamma-gamma-absorbed energy above
                           # 47 keV that becomes pairs, not heat
                           # (imctrk2d.f:429-434 excludes it from edep;
                           # it re-enters the electrons via dn_pp) —
                           # tallied so the photon-side audit closes
                           # once k_gg builds up
    e_src_lost: jnp.ndarray  # () source energy lost to slot overflow
    e_rr: jnp.ndarray      # () realized census-roulette energy delta
    n_rr: jnp.ndarray      # () int32 census photons rouletted away
    trk_rounds: jnp.ndarray  # () int32 flight-loop iterations used

    @classmethod
    def zeros(cls, nz, nr, num_nt, nphfield, n_gg, nmu, nphtotal, nph_lc):
        f = jnp.zeros
        return cls(
            edep=f((nz, nr)), prdep=f((nz, nr)), ecens=f((nz, nr)),
            npcen=f((nz, nr)),
            n_field=f((nz, nr, nphfield)),
            n_ph=f((nz, nr, n_gg)),
            e_ic=f((num_nt,)),
            n_esp=f((num_nt,)),
            fout=f((nmu, nphtotal)),
            edout=f((nmu, nph_lc)),
            erlk_inner=f((nz,)), erlk_outer=f((nz,)),
            erlk_upper=f((nr,)), erlk_lower=f((nr,)),
            ed_in=f((nr,)), ed_ref=f((nr,)),
            e_killed=f(()),
            e_scatter=f(()),
            e_pair_abs=f(()),
            e_src_lost=f(()),
            e_rr=f(()),
            n_rr=jnp.zeros((), jnp.int32),
            trk_rounds=jnp.zeros((), jnp.int32),
        )


class EventBuffer(NamedTuple):
    """Fixed-capacity escaping-photon event records for one step
    (the reference's per-rank event files, imcleak2d.f:105 format:
    t_bound, xnu, ew, rpre, zpre, wmu, phi)."""

    data: jnp.ndarray     # (capacity, 7) float32
    count: jnp.ndarray    # (1,) int32 — records written (may exceed
                          # capacity; shape (1,) so it shards per device)

    @classmethod
    def empty(cls, capacity: int) -> "EventBuffer":
        return cls(
            data=jnp.zeros((capacity, 7), jnp.float32),
            count=jnp.zeros((1,), jnp.int32),
        )


class SimState(NamedTuple):
    """Full simulation state advanced by one ``step``."""

    zones: ZoneState
    photons: PhotonArray     # census photon population (device-sharded)
    time: jnp.ndarray        # () float64 [s]
    dt: jnp.ndarray          # () float64 current step [s]
    dt_prev: jnp.ndarray     # () float64 previous step (dt(2))
    ncycle: jnp.ndarray      # () int32
    key: jax.Array           # PRNG key
    ed_abs: jnp.ndarray      # (nr,) disk-absorbed energy (dh_sentinel)
    ed_ref: jnp.ndarray      # (nr,) reflected energy from previous step
    k_gg: jnp.ndarray        # (nz, nr, n_gg) gamma-gamma opacity [1/cm]
    dn_pp: jnp.ndarray       # (nz, nr, num_nt) pair-production source
    dne_pa: jnp.ndarray      # (nz, nr, num_nt) electron annihilation sink
    dnp_pa: jnp.ndarray      # (nz, nr, num_nt) positron annihilation sink


def init_zone_state(cfg: SimConfig, zone_init, tables) -> ZoneState:
    """Build the initial ZoneState from per-zone initial conditions
    (setup2d.f:122-139). The distribution build is one fused jit, not
    a chain of small eager ops that each compile and dispatch."""
    import numpy as np

    from compton2d_tpu.physics import electron_dist as ed

    f = lambda a: np.asarray(a, np.float32)
    tea = f(zone_init.tea)
    amxwl = f(zone_init.amxwl)
    gmin = f(zone_init.gmin)
    gmax = f(zone_init.gmax)
    p_nth = f(zone_init.p_nth)

    @jax.jit
    def _build(gnt, tea, amxwl, gmin, gmax, p_nth):
        f_nt = ed.init_f_nt(gnt, tea, amxwl, gmin, gmax, p_nth)
        return f_nt, ed.build_cdf(f_nt, gnt)

    f_nt, cdf = _build(tables.gnt, tea, amxwl, gmin, gmax, p_nth)
    shape = tea.shape
    num_nt = tables.gnt.shape[0]
    return ZoneState(
        tea=tea,
        tna=f(zone_init.tna),
        n_e=f(zone_init.n_e),
        B_field=f(zone_init.B_field),
        amxwl=amxwl,
        gmin=gmin,
        gmax=gmax,
        p_nth=p_nth,
        q_turb=f(zone_init.q_turb),
        turb_lev=f(zone_init.turb_lev),
        ep_switch=np.asarray(zone_init.ep_switch, np.int32),
        f_nt=f_nt,
        cdf_nt=cdf,
        f_pair=np.zeros(shape, np.float32),
        n_pos=np.zeros(shape + (num_nt,), np.float32),
        ec_old=np.zeros(shape, np.float32),
    )
