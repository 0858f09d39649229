"""Device mesh + sharding specs for the photon-parallel step.

The reference's distributed structure (SURVEY.md §2.7) maps onto a
1-D device mesh as:

- P1 replicated-state broadcast  -> zone fields replicated (free);
- P2 zone task farms             -> batched compute (no comm at all);
- P3 photon-parallel tracking    -> PhotonArray sharded over the 'photons'
  mesh axis; the reference's explicit load rebalancing (imcredist.f)
  disappears because every device sources an equal photon budget and
  zone state is replicated;
- P4 tally tree-reductions       -> jax.lax.psum over 'photons'
  (deterministic by construction, unlike MPI_REDUCE order).

The driver wraps its step in jax.shard_map with these specs; on one
device the specs degenerate to no-ops.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def shard_map(f, mesh, in_specs, out_specs, check_vma=False):
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=check_vma,
    )


AXIS = "photons"


def make_photon_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices).reshape(-1), (AXIS,))


def sharded_specs(tree):
    """Shard every leaf's leading axis over the photon axis."""
    return jax.tree_util.tree_map(lambda _: P(AXIS), tree)


def replicated_specs(tree):
    return jax.tree_util.tree_map(lambda _: P(), tree)


def simstate_specs(state):
    """SimState specs: photon SoA sharded, everything else replicated."""
    specs = jax.tree_util.tree_map(lambda _: P(), state)
    return specs._replace(photons=sharded_specs(state.photons))


def is_multiprocess(mesh: Mesh) -> bool:
    return (
        len({d.process_index for d in mesh.devices.flat}) > 1
    )


def put_global(tree, specs, mesh: Mesh):
    """Build global jax.Arrays for a (possibly multi-process) mesh from
    host-replicated numpy values. Every process holds the full logical
    value (initial state is computed identically everywhere), so each
    shard is materialized by slicing it."""
    from jax.sharding import NamedSharding

    def put(x, spec):
        xv = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            xv.shape, sh, lambda idx: xv[idx]
        )

    return jax.tree_util.tree_map(put, tree, specs)
