"""Census population control: weight-window Russian roulette.

The reference caps the census at 5e6 photons per rank and hard-stops the
whole run on overflow (``/root/reference/src/general.pa:7``,
``src/imctrk2d.f:573-577``); its only in-flight control is the silent
weight-floor kill (``imctrk2d.f:81-91``). With fixed-capacity slot
arrays a saturated census would instead silently starve fresh emission
(the ``e_src_lost`` tally). This module replaces both failure modes with
*weight-preserving Russian roulette*:

when alive-slot occupancy exceeds ``hi``, choose a roulette weight
``wc`` such that the expected survivor count equals ``lo * n_slots``;
each photon survives with probability ``p = min(1, w/wc)`` and weight
``w/p = max(w, wc)``. Low-weight photons are culled preferentially, the
expected energy of every slot is preserved exactly, and the realized
energy delta is tallied (``e_rr``) so the per-step audit stays exact
(the budget uses the post-roulette census energy).

``wc`` solves sum(min(1, w_i/wc)) = target; the left side is monotone
decreasing in wc so 32 bisection rounds (O(n) each, only on the rare
triggered steps behind a ``lax.cond``) pin it to f32 precision.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from compton2d_tpu.state import PhotonArray


def _roulette_weight(w: jnp.ndarray, alive: jnp.ndarray, target):
    """Bisect for wc with sum(min(1, w/wc)) = target survivors."""
    w = jnp.where(alive, w, 0.0).astype(jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    total = jnp.sum(w)
    lo = jnp.full((), 1e-30, jnp.float32)
    # count(total/target) <= sum(w)/(total/target) = target
    hi = jnp.maximum(total / jnp.maximum(target, 1.0), 2e-30)

    def body(_, carry):
        lo, hi = carry
        mid = jnp.sqrt(lo * hi)  # log-scale bisection
        cnt = jnp.sum(jnp.minimum(w / mid, 1.0))
        return jnp.where(cnt > target, mid, lo), jnp.where(
            cnt > target, hi, mid
        )

    lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
    return jnp.sqrt(lo * hi)


def census_roulette(
    photons: PhotonArray,
    key: jax.Array,
    occupancy_hi: float,
    occupancy_lo: float,
    n_reserve=None,
) -> Tuple[PhotonArray, jnp.ndarray, jnp.ndarray]:
    """Apply the weight window if occupancy > hi OR the free slots can't
    hold ``n_reserve`` fresh photons (the step's actual emission count);
    returns (photons, e_rr realized energy delta [scaled], n_rolled)."""
    n = photons.n_slots
    n_alive = jnp.sum(photons.alive.astype(jnp.int32))
    trigger = n_alive > int(occupancy_hi * n)
    target = jnp.float32(occupancy_lo * n)
    if n_reserve is not None:
        # leave room for this step's emission plus a 12.5% margin
        need = n_reserve.astype(jnp.int32)
        trigger = trigger | (n - n_alive < need)
        target = jnp.clip(
            jnp.minimum(target, (n - need - need // 8).astype(jnp.float32)),
            n // 8, n,
        )

    def do_rr(ph):
        wc = _roulette_weight(ph.w, ph.alive, target)
        p = jnp.minimum(ph.w / wc, 1.0)
        u = jax.random.uniform(key, (n,), jnp.float32)
        survive = ph.alive & (u < p)
        w_new = jnp.where(survive, jnp.maximum(ph.w, wc), 0.0)
        e_rr = jnp.sum(jnp.where(ph.alive, ph.w, 0.0)) - jnp.sum(w_new)
        n_rolled = jnp.sum((ph.alive & ~survive).astype(jnp.int32))
        ph = ph._replace(
            w=jnp.where(ph.alive, w_new, ph.w), alive=survive
        )
        return ph, e_rr, n_rolled

    def no_rr(ph):
        return ph, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)

    return jax.lax.cond(trigger, do_rr, no_rr, photons)
