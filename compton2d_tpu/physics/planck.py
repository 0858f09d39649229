"""Vectorized Planck / Wien photon-energy sampler.

Canfield's classic sampler (``/root/reference/src/planck2d.f:37-65``):
``x = -ln(u1 u2 u3 u4) * T / m`` with the harmonic index ``m`` drawn with
probability 1/m^4 / zeta(4) (Planck) or m = 1 (Wien). The reference walks
the zeta series per photon; here the series is a precomputed CDF and all
photons sample with one searchsorted.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_ZETA4 = float(np.pi**4 / 90.0)   # = 1.08232...
_M_MAX = 64
_CDF_M = np.cumsum(1.0 / np.arange(1, _M_MAX + 1, dtype=np.float64) ** 4)


def sample_planck(
    key: jax.Array,
    T_keV: jnp.ndarray,
    wien: bool = False,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Draw photon energies [keV] from a Planck (or Wien) spectrum at
    temperature(s) ``T_keV`` (broadcast shape = output shape)."""
    shape = jnp.shape(T_keV)
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(
        k1, shape + (4,), dtype=jnp.float32, minval=1e-12, maxval=1.0
    )
    ap0 = -jnp.sum(jnp.log(u), axis=-1)
    if wien:
        inv_m = jnp.ones(shape, dtype)
    else:
        rn = jax.random.uniform(k2, shape, dtype=jnp.float32) * _ZETA4
        # compare-count form of searchsorted
        cdf = jnp.asarray(_CDF_M, jnp.float32)
        m = jnp.sum(
            (cdf[None, :] < rn[..., None]).astype(jnp.int32), axis=-1
        ) + 1
        inv_m = 1.0 / m.astype(dtype)
    return (ap0 * inv_m).astype(dtype) * jnp.asarray(T_keV, dtype)
