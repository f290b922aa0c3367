"""Device mesh utilities.

The reference distributes fragments through a 3-tier MPI request/reply
hierarchy (global coordinator / group coordinators / node workers,
src/fragmentation/mbe/mqc_mbe_mpi_fragment_distribution_scheme.F90 in
the reference). Here the entire scheme collapses into SPMD: fragments are
a batch axis sharded over a `jax.sharding.Mesh`; XLA inserts the
collectives.

The reference's topology knobs (`global_groups` / `nodes_per_group`,
mqc_driver.f90:354-388) map to mesh axis factors here: a 2D ('group',
'frag') mesh whose outer axis has `global_groups` slots (or n_devices /
nodes_per_group). The fragment batch axis is sharded over BOTH axes, so
results are identical for every layout. The layout only mirrors the
requested group topology: the cards of one host are joined all to all by
NVLink, so no axis is slower than the other and the mesh shape carries
no placement cost.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAG_AXIS = "frag"
GROUP_AXIS = "group"


def _resolve_groups(n_devices, global_groups=None, nodes_per_group=None):
    """Number of groups from the reference's mutually-exclusive knobs."""
    if global_groups:
        g = int(global_groups)
    elif nodes_per_group:
        g = max(1, n_devices // max(1, int(nodes_per_group)))
    else:
        return 1
    g = max(1, min(g, n_devices))
    while n_devices % g:  # groups must tile the device count
        g -= 1
    return g


def fragment_mesh(devices=None, global_groups=None, nodes_per_group=None) -> Mesh:
    """Mesh over all (or the given) devices.

    Without topology knobs: 1D ('frag',). With `global_groups` /
    `nodes_per_group`: 2D ('group', 'frag') with the group count tiling the
    device count (rounded down to the nearest divisor, like the reference's
    chunked round-robin assignment).
    """
    if devices is None:
        devices = jax.devices()
    devices = np.array(devices)
    g = _resolve_groups(devices.size, global_groups, nodes_per_group)
    if g <= 1:
        return Mesh(devices, (FRAG_AXIS,))
    return Mesh(devices.reshape(g, devices.size // g), (GROUP_AXIS, FRAG_AXIS))


def batch_spec(mesh: Mesh, ndim: int) -> P:
    """PartitionSpec sharding a leading batch axis over ALL mesh axes."""
    if ndim < 1:
        return P()
    axes = tuple(mesh.axis_names)
    lead = axes if len(axes) > 1 else axes[0]
    return P(lead, *([None] * (ndim - 1)))


def shard_leading_axis(tree, mesh: Mesh):
    """Place a pytree with NamedSharding splitting the leading (batch) axis."""

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, batch_spec(mesh, x.ndim)))

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )
