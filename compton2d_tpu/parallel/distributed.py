"""Multi-process (multi-host) scale-out.

The reference scales with MPI ranks exchanging photons through a master
(`src/imcredist.f`, `vol_mpi.f`, `surf_mpi.f`); this
design replaces every one of those patterns (SURVEY.md §2.7):

- zone state is replicated (P1 broadcast is free),
- zone work is batched (P2 task farms disappear),
- the photon population is sharded over the *global* device mesh (P3) —
  across processes the `psum` tally reductions are collectives that
  XLA inserts; no explicit photon exchange is needed because every
  device owns an equal photon budget against replicated zone state
  (what imcredist rebalanced by hand),
- tallies reduce deterministically with `psum` (P4).

Each process spools only its own devices' escaping-photon records (the
analogue of the per-rank ``pNNN_evb.dat`` files): see
``io.events.buffer_to_numpy``.

Usage (one process per host, or N processes on one machine for
testing — see tools/weak_scaling.py):

    from compton2d_tpu.parallel import distributed as dist
    dist.initialize(coordinator, num_processes, process_id)
    mesh = dist.global_photon_mesh()
    sim = Simulation(cfg, zones, mesh=mesh)
"""
from __future__ import annotations

import jax

from compton2d_tpu.parallel.mesh import AXIS, make_photon_mesh


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
):
    """jax.distributed bring-up (idempotent). ``local_device_count``
    limits this process to its first that many local devices."""
    kw = {}
    if local_device_count is not None:
        kw["local_device_ids"] = list(range(local_device_count))
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kw,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_photon_mesh():
    """1-D photon mesh over every device of every process."""
    return make_photon_mesh(jax.devices())


def process_event_path(path: str) -> str:
    """Per-process event-file name, pNNN_<name> like the reference
    (xec2d.f evlfilename)."""
    import os

    d, b = os.path.split(path)
    return os.path.join(d, f"p{jax.process_index():03d}_{b}")
