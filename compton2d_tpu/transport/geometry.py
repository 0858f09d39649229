"""Cylindrical (r, z) flight geometry, vectorized over photon slots.

Re-implements the tracker's geometry block
(``/root/reference/src/imctrk2d.f:228-379, 467-484``):

- distance to the nearest zone boundary (inner/outer r-shell or z-plane)
  along the current direction;
- the post-move direction update.

Differences from the reference (deliberate, for vectorized tracking):

- the azimuth is carried as a unit vector (cphi, sphi) = (cos, sin) of
  the angle between the horizontal velocity component and the local
  outward radial direction, instead of (phi, Eta_switch) with
  acos/quadrant bookkeeping (imctrk2d.f:228-247, 475-483). The update
  after a horizontal advance f is exact and trig-free:
      cphi' = (f + cphi * r) / r'        (the 20121113 clamping fix,
      sphi' = sphi * r / r'               src_20121113/imctrk2d.f:477-479)
  and (cphi', sphi') stays normalized identically;
- everything is branch-free masked arithmetic over the photon SoA.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_CLAMP = 0.99999999


class FlightGeom(NamedTuple):
    trldb: jnp.ndarray    # distance to nearest boundary [cm]
    jnew: jnp.ndarray     # int32 zone z-index after crossing
    knew: jnp.ndarray     # int32 zone r-index after crossing
    rbnd: jnp.ndarray     # radius at the boundary point
    zbnd: jnp.ndarray     # height at the boundary point


def distance_to_boundary(
    r: jnp.ndarray, z: jnp.ndarray,
    mu: jnp.ndarray, cphi: jnp.ndarray, sphi: jnp.ndarray,
    jz: jnp.ndarray, kr: jnp.ndarray,
    r_edges: jnp.ndarray, z_edges: jnp.ndarray,
) -> FlightGeom:
    """imctrk2d.f:228-360, all photons at once. Inputs f32, zone indices
    0-based and assumed in range."""
    eta = jnp.clip(cphi, -_CLAMP, _CLAMP)
    mu_c = jnp.clip(mu, -_CLAMP, _CLAMP)
    sin_mu = jnp.sqrt(1.0 - mu_c * mu_c)

    r_in = r_edges[kr]            # inner shell radius of current zone
    r_out = r_edges[kr + 1]
    disp = eta * r
    psq = (r * sphi) ** 2         # = r^2 (1 - eta^2), exact with (c, s)

    inward = (eta < 0.0) & (psq < r_in * r_in)
    inout = jnp.where(inward, -1.0, 1.0)
    rbnd_shell = jnp.where(inward, r_in, r_out)
    dpbsq = jnp.maximum(rbnd_shell * rbnd_shell - psq, 1e-6)
    disbr = inout * jnp.sqrt(dpbsq) - disp      # horizontal chord length
    disbr = jnp.maximum(disbr, 0.0)
    # distance along the ray to the r-shell
    trldb_r = disbr / jnp.maximum(sin_mu, 1e-12)
    z_r = z + mu_c * trldb_r                    # height at shell crossing

    z_top = z_edges[jz + 1]
    z_bot = z_edges[jz]
    hits_top = z_r > z_top
    hits_bot = z_r < z_bot

    # z-plane crossing (imctrk2d.f:276-343)
    zbnd_z = jnp.where(hits_top, z_top, z_bot)
    f_z = (zbnd_z - z) * sin_mu / jnp.where(
        jnp.abs(mu_c) > 1e-12, mu_c, 1e-12
    )
    f_z = jnp.maximum(f_z, 0.0)
    r_z = jnp.sqrt(
        jnp.maximum(r * r + f_z * f_z + 2.0 * r * f_z * eta, 0.0)
    )
    trldb_z = jnp.sqrt(f_z * f_z + (zbnd_z - z) ** 2)

    hits_zplane = hits_top | hits_bot
    trldb = jnp.where(hits_zplane, trldb_z, trldb_r)
    jnew = jnp.where(
        hits_top, jz + 1, jnp.where(hits_bot, jz - 1, jz)
    ).astype(jnp.int32)
    knew = jnp.where(
        hits_zplane, kr, kr + inout.astype(jnp.int32)
    ).astype(jnp.int32)
    rbnd = jnp.where(hits_zplane, r_z, rbnd_shell)
    zbnd = jnp.where(hits_zplane, zbnd_z, z_r)
    return FlightGeom(trldb=trldb, jnew=jnew, knew=knew, rbnd=rbnd, zbnd=zbnd)


def advance(
    r: jnp.ndarray, z: jnp.ndarray,
    mu: jnp.ndarray, cphi: jnp.ndarray, sphi: jnp.ndarray,
    trld: jnp.ndarray,
    rnew: jnp.ndarray | None = None,
    znew: jnp.ndarray | None = None,
):
    """Move a distance ``trld`` along the current direction; return
    (r', z', cphi', sphi') (imctrk2d.f:372-377, 467-484). When the move
    ends on a known boundary, pass ``rnew``/``znew`` to pin the exact
    boundary coordinates."""
    mu_c = jnp.clip(mu, -_CLAMP, _CLAMP)
    f_h = trld * jnp.sqrt(1.0 - mu_c * mu_c)
    if rnew is None:
        rnew = jnp.sqrt(
            jnp.maximum(f_h * f_h + r * r + 2.0 * f_h * r * cphi, 0.0)
        )
    if znew is None:
        znew = z + trld * mu_c
    rs = jnp.maximum(rnew, 1e-20)
    cphi_n = jnp.clip((f_h + cphi * r) / rs, -1.0, 1.0)
    sphi_n = jnp.clip(sphi * r / rs, -1.0, 1.0)
    # renormalize against f32 drift
    nrm = jnp.sqrt(jnp.maximum(cphi_n**2 + sphi_n**2, 1e-12))
    return rnew, znew, cphi_n / nrm, sphi_n / nrm
