"""compton2d_tpu — a 2-D Implicit-Monte-Carlo Comptonization +
Fokker-Planck framework in JAX, compiled by XLA for an NVIDIA GPU
(tests run on the CPU).

Re-designed from scratch with the capabilities of the reference Fortran/MPI
code ``bbw7561135/Compton2d`` (see SURVEY.md):

- time-dependent photon transport in 2-D cylindrical (r, z) geometry with
  Compton scattering off hybrid thermal + nonthermal electron populations
  (full Klein-Nishina), continuous absorption, gamma-gamma pair opacity,
  Compton reflection, and time-of-flight census between steps;
- per-zone electron evolution via a Chang-Cooper-discretized Fokker-Planck
  equation (IC, synchrotron, stochastic acceleration, Coulomb/Moller,
  injection, escape, pair sources);
- escaping-photon event records, time-integrated angle-resolved spectra,
  energy- and angle-binned light curves, and Doppler-boosted post-processing
  for relativistic jets.

Architecture (none of this is a port of the reference's master-worker
MPI task farm):

- state is pytrees (``ZoneState``, ``PhotonArray`` SoA, ``Tallies``), not a
  COMMON block;
- photon tracking is a vectorized lock-step flight loop (an XLA
  ``while_loop``) over photon slots with counter-based threefry RNG — one
  stream per (step, iteration);
- the per-zone total Compton cross section is built each step as a single
  matmul  sigma_E(E_grid, gamma_grid) @ f_nt(gamma_grid, zones)  instead
  of the reference's per-photon 200-term integral
  (``src/comtot2d.f:219-247`` of the reference);
- zone task farms (``imcvol2d_para.f``/``imcsurf2d_para.f``/``update2d.f``)
  become batched vectorized samplers and a batched tridiagonal solve;
- MPI reductions become ``jax.lax.psum`` over a device mesh; photon
  populations are sharded over devices (data parallel) with deterministic
  tallies.

Precision policy: EVERYTHING on device is float32, with unit scaling —
lengths in units of L0 = max(r_max, z_max), energies in units of
E0 = RunConfig.energy_scale — because cgs magnitudes (1e56 erg, 1e45 cm^3)
overflow the f32 range and float64 runs far below float32 speed on the
accelerator. Float32 matmuls are pinned to ``Precision.HIGHEST`` so no
product runs with reduced-precision (TF32/bf16) operands.
Setup-time tables are built in host numpy float64 and cast to f32 device
constants. Scalar fold-factors (e.g. sigma_SB * L0^2 / E0) are combined
in Python floats before touching traced arrays so no intermediate leaves
the f32 range.
"""

from compton2d_tpu import constants  # noqa: E402
from compton2d_tpu.config import (  # noqa: E402
    GridConfig,
    PhysicsConfig,
    SourceConfig,
    RunConfig,
    SimConfig,
)

__version__ = "0.1.0"

__all__ = [
    "constants",
    "GridConfig",
    "PhysicsConfig",
    "SourceConfig",
    "RunConfig",
    "SimConfig",
    "__version__",
]
