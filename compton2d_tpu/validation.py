"""Statistical and numerical comparisons between two runs of the step.

Two runs of the Monte-Carlo step on different devices or device counts
cannot agree bit for bit: their random streams differ (one per device
on a mesh) or float rounding sends trajectories apart. They are
compared by a K-seed-replicate z-test on whole-step totals. Deterministic
phases are compared elementwise within a stated tolerance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

CHANNELS = ("census", "escaped", "edep")


def step_totals(tallies) -> dict:
    """Census, escaped and (absolute) deposited energy of one step."""
    t = tallies
    return {
        "census": float(jnp.sum(t.ecens)),
        "escaped": float(
            jnp.sum(t.erlk_inner) + jnp.sum(t.erlk_outer)
            + jnp.sum(t.erlk_upper) + jnp.sum(t.erlk_lower)
        ),
        "edep": float(jnp.sum(jnp.abs(t.edep))),
    }


def replicate_totals(sim, seeds, steps: int = 3) -> dict:
    """Run ``steps`` steps from the simulation's initial state once per
    seed and collect the last step's totals per channel. Reseeding
    swaps only the PRNG-key leaf, so nothing recompiles."""
    state0 = sim.state
    ch = {k: [] for k in CHANNELS}
    for s in seeds:
        sim.state = state0._replace(key=jax.random.PRNGKey(s))
        for _ in range(steps):
            out = sim.step()
        for k, v in step_totals(out.tallies).items():
            ch[k].append(v)
    sim.state = state0
    return {k: np.asarray(v, np.float64) for k, v in ch.items()}


def ztest(a: dict, b: dict) -> dict:
    """z = |mean_a - mean_b| / sqrt(var_a/K_a + var_b/K_b) per channel
    of two replicate sets from :func:`replicate_totals`."""
    zs = {}
    for k in a:
        se = np.sqrt(
            a[k].var(ddof=1) / len(a[k]) + b[k].var(ddof=1) / len(b[k])
        )
        zs[k] = float(abs(a[k].mean() - b[k].mean()) / max(se, 1e-300))
    return zs


def max_rel_err(got, ref, atol_frac: float = 0.0) -> float:
    """max |got - ref| / (|ref| + atol_frac * max|ref|) over all
    elements: a relative error in which entries far below the array's
    scale are held to an absolute floor instead."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} != {ref.shape}")
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(ref))):
        return float("inf")
    if ref.size == 0:
        return 0.0
    floor = atol_frac * float(np.max(np.abs(ref)))
    den = np.abs(ref) + floor
    diff = np.abs(got - ref)
    err = np.where(den > 0, diff / np.where(den > 0, den, 1.0),
                   np.where(diff > 0, np.inf, 0.0))
    return float(np.max(err))
