"""Chang-Cooper discretization + batched tridiagonal (Thomas) solve.

Re-implements the FP matrix build of ``FP_calc``
(``/root/reference/src/update2d.f:1363-1390``) and the ``tridag`` Thomas
solver (``update2d.f:2476-2518``), vectorized over all zones at once —
the reference farms zones to MPI workers one at a time (SURVEY.md §2.7
P2); here the zone axis is a batch axis and the 200-bin recurrence runs
as a ``lax.scan``.

The Chang-Cooper weight functions w/(e^w - 1) and w/(1 - e^-w) are
evaluated with expm1-stable forms.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _w_over_expm1(w: jnp.ndarray) -> jnp.ndarray:
    """w / (e^w - 1), stable for |w| -> 0 and large |w|."""
    wc = jnp.clip(w, -500.0, 500.0)
    small = jnp.abs(wc) < 1e-8
    safe = jnp.where(small, 1.0, wc)
    return jnp.where(small, 1.0 - 0.5 * wc, safe / jnp.expm1(safe))


def _w_over_one_minus_exp_neg(w: jnp.ndarray) -> jnp.ndarray:
    """w / (1 - e^-w) = w + w/(e^w - 1)."""
    return w + _w_over_expm1(w)


def chang_cooper_coeffs(
    gnt: jnp.ndarray,    # (num_nt,)
    dgdt: jnp.ndarray,   # (..., num_nt) drift  [1/s] (negative = cooling)
    disp: jnp.ndarray,   # (..., num_nt) dispersion [1/s]
    d_t: jnp.ndarray,    # (...,) substep [s]
    t_esc: jnp.ndarray,  # () or (...,) escape time [s]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Tridiagonal coefficients (a, b, c), shapes (..., num_nt)
    (update2d.f:1363-1390)."""
    num_nt = gnt.shape[0]
    d_gm = jnp.concatenate([gnt[1:2] - gnt[0:1], gnt[1:] - gnt[:-1]])
    # D_gplus(i) = gnt(i+1) - gnt(i); last entry unused
    d_gp = jnp.concatenate([gnt[1:] - gnt[:-1], gnt[-1:] - gnt[-2:-1]])
    delta_g = jnp.sqrt(gnt / jnp.concatenate([gnt[0:1], gnt[:-1]])) * d_gm

    dgdt_p1 = jnp.roll(dgdt, -1, axis=-1)
    disp_p1 = jnp.roll(disp, -1, axis=-1)
    big_b = -(dgdt + dgdt_p1) / 2.0
    big_c = jnp.maximum((disp + disp_p1) / 2.0, 1e-30)
    # the reference's index-1 seed lacks the 1/2 on B (update2d.f:1369)
    big_b = big_b.at[..., 0].set(-(dgdt[..., 0] + dgdt[..., 1]))
    smw = d_gp * big_b / big_c
    # smw(1) uses D_gminus(2) = gnt(2)-gnt(1) = d_gp(1); same value here.
    big_w = _w_over_expm1(smw)
    w_pos = _w_over_one_minus_exp_neg(smw)   # smw/(1 - e^-smw)

    dt_e = d_t[..., None]
    c = -dt_e * big_c * w_pos / (delta_g * d_gp)
    big_c_m1 = jnp.roll(big_c, 1, axis=-1)
    big_w_m1 = jnp.roll(big_w, 1, axis=-1)
    w_pos_m1 = jnp.roll(w_pos, 1, axis=-1)
    b = (
        1.0
        + dt_e / delta_g * (
            big_c * big_w / d_gp + big_c_m1 * w_pos_m1 / d_gm
        )
        + dt_e / jnp.asarray(t_esc)[..., None]
    )
    a = -dt_e / delta_g * big_c_m1 * big_w_m1 / d_gm

    # boundary rows (update2d.f:1319-1324)
    zero = jnp.zeros_like(a[..., 0])
    one = jnp.ones_like(a[..., 0])
    a = a.at[..., 0].set(zero).at[..., num_nt - 1].set(zero)
    b = b.at[..., 0].set(one).at[..., num_nt - 1].set(one)
    c = c.at[..., 0].set(zero).at[..., num_nt - 1].set(zero)
    return a, b, c


def pcr_solve(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, d: jnp.ndarray,
    clamp_negative: bool = True,
) -> jnp.ndarray:
    """Parallel cyclic reduction along the last axis.

    Solves the same tridiagonal systems as :func:`thomas_solve` but in
    ceil(log2 N) full-width vector rounds instead of 2N sequential scan
    steps: each Thomas step touches only the small zone batch, while
    PCR does (Z, N) elementwise work per round. The Chang-Cooper
    systems are strictly diagonally dominant (b >= 1 + positive terms,
    a, c <= 0, update2d.f:1363-1390), for which PCR is stable. Results
    agree with Thomas to f32 roundoff (tests/test_fp.py)."""
    n = a.shape[-1]
    steps = max(1, (n - 1).bit_length())

    def shift(x, s, fill):
        # x shifted by s along the last axis, vacated slots = fill
        if s == 0:
            return x
        pad = jnp.full_like(x[..., :abs(s)], fill)
        if s > 0:      # neighbor i-s
            return jnp.concatenate([pad, x[..., :-s]], axis=-1)
        return jnp.concatenate([x[..., -s:], pad], axis=-1)

    s = 1
    for _ in range(steps):
        b_m = shift(b, s, 1.0)
        b_p = shift(b, -s, 1.0)
        alpha = -a / b_m
        gamma = -c / b_p
        a_n = alpha * shift(a, s, 0.0)
        c_n = gamma * shift(c, -s, 0.0)
        b_n = b + alpha * shift(c, s, 0.0) + gamma * shift(a, -s, 0.0)
        d_n = d + alpha * shift(d, s, 0.0) + gamma * shift(d, -s, 0.0)
        a, b, c, d = a_n, b_n, c_n, d_n
        s *= 2
    out = d / jnp.where(jnp.abs(b) < 1e-30, 1e-30, b)
    if clamp_negative:
        out = jnp.maximum(out, 0.0)
    return out


def thomas_solve(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, d: jnp.ndarray,
    clamp_negative: bool = True,
) -> jnp.ndarray:
    """Batched Thomas algorithm along the last axis (update2d.f:2476-2518).

    ``clamp_negative`` reproduces the reference's f_new >= 0 clamp in the
    back-substitution (update2d.f:2512-2514).
    """
    num_nt = a.shape[-1]

    def fwd(carry, xs):
        bet, f_prev = carry
        a_i, b_i, c_im1, d_i = xs
        gam_i = c_im1 / bet
        bet_new = b_i - a_i * gam_i
        bet_new = jnp.where(jnp.abs(bet_new) < 1e-30, 1e-30, bet_new)
        f_i = (d_i - a_i * f_prev) / bet_new
        return (bet_new, f_i), (f_i, gam_i)

    aT = jnp.moveaxis(a, -1, 0)
    bT = jnp.moveaxis(b, -1, 0)
    cT = jnp.moveaxis(c, -1, 0)
    dT = jnp.moveaxis(d, -1, 0)
    c_shift = jnp.concatenate([jnp.zeros_like(cT[:1]), cT[:-1]], axis=0)

    bet0 = jnp.where(jnp.abs(bT[0]) < 1e-30, 1e-30, bT[0])
    f0 = dT[0] / bet0
    (_, _), (fs, gams) = jax.lax.scan(
        fwd, (bet0, f0), (aT[1:], bT[1:], cT[:-1], dT[1:])
    )
    fs = jnp.concatenate([f0[None], fs], axis=0)      # (num_nt, ...)
    gams = jnp.concatenate([jnp.zeros_like(gams[:1]), gams], axis=0)

    def bwd(f_next, xs):
        # back-substitution uses the *unclamped* upstream value, as in
        # the reference (clamp happens after use, update2d.f:2508-2514)
        f_i, gam_ip1 = xs
        f_new = f_i - gam_ip1 * f_next
        return f_new, f_new

    f_last = fs[-1]
    _, out_rev = jax.lax.scan(
        bwd, f_last, (fs[:-1][::-1], gams[1:][::-1])
    )
    out = jnp.concatenate([out_rev[::-1], f_last[None]], axis=0)
    if clamp_negative:
        out = jnp.maximum(out, 0.0)
    return jnp.moveaxis(out, 0, -1)
