"""Many-Body Expansion assembly.

The reference assembles bottom-up per level with hash-table subset lookups
(/root/reference/src/fragmentation/mbe/mqc_mbe.f90:587-1029, delta recurrence
:32-94). Here the same algebra is reorganized batch-first:

1. Scalar deltas per fragment (for the JSON breakdown) use a dense
   precomputed subset-index table — a vectorizable gather + segment-sum
   instead of per-query hashing.
2. Totals use closed-form inclusion-exclusion WEIGHTS: for a subset-closed
   family, delta_f = sum_{s subseteq f} (-1)^(|f|-|s|) E_s, so the MBE total
   is sum_f c_f E_f with integer c_f = sum_{g supseteq f} (-1)^(|g|-|f|).
   Gradients/Hessians/dipole derivatives then accumulate STREAMING as
   c_f * redistribute(frag_f) — eliminating the reference's
   (3N)^2 x n_fragments delta-Hessian storage (mqc_mbe.f90:705).
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional

import numpy as np

from ..geometry import (
    SystemGeometry,
    redistribute_dipole_derivatives,
    redistribute_gradient,
    redistribute_hessian,
)
from ..results import MbeResult
from .combinatorics import build_lookup, polymer_key, polymer_levels


def mbe_weights(polymers: np.ndarray) -> np.ndarray:
    """Inclusion-exclusion weight c_f of each fragment in the MBE total.

    c_f = sum over fragments g in the family with g superseteq f of
    (-1)^(|g| - |f|). Requires (and validates) subset closure.
    Uses the C++ host runtime when available.
    """
    from .. import native

    if native.available():
        return native.mbe_weights(np.ascontiguousarray(polymers))
    lookup = build_lookup(polymers)
    F = polymers.shape[0]
    c = np.zeros(F, dtype=np.int64)
    for g_idx, row in enumerate(polymers):
        mono = sorted(int(x) for x in row[row >= 0])
        n = len(mono)
        for r in range(1, n + 1):
            sign = (-1) ** (n - r)
            for combo in combinations(mono, r):
                idx = lookup.get(combo)
                if idx is None:
                    raise ValueError(
                        f"subset {combo} of {mono} missing: family not closed"
                    )
                c[idx] += sign
    return c


def mbe_deltas(polymers: np.ndarray, energies: np.ndarray) -> np.ndarray:
    """Per-fragment delta energies via bottom-up recurrence.

    delta_f = E_f - sum of deltas of all proper subsets (order-independent
    because processing is by level). Uses the C++ host runtime when
    available."""
    from .. import native

    if native.available():
        return native.mbe_deltas(
            np.ascontiguousarray(polymers), np.asarray(energies, dtype=float)
        )
    lookup = build_lookup(polymers)
    levels = polymer_levels(polymers)
    F = polymers.shape[0]
    deltas = np.zeros(F)
    for lvl in range(1, int(levels.max(initial=0)) + 1):
        for i in np.nonzero(levels == lvl)[0]:
            mono = sorted(int(x) for x in polymers[i][polymers[i] >= 0])
            acc = energies[i]
            for r in range(1, lvl):
                for combo in combinations(mono, r):
                    acc -= deltas[lookup[combo]]
            deltas[i] = acc
    return deltas


def compute_mbe(
    polymers: np.ndarray,
    sys_geom: SystemGeometry,
    fragments: list,
    energies: np.ndarray,
    gradients: Optional[list] = None,
    hessians: Optional[list] = None,
    dipoles: Optional[np.ndarray] = None,
    dipole_derivatives: Optional[list] = None,
    distances: Optional[np.ndarray] = None,
    max_level: Optional[int] = None,
) -> MbeResult:
    """Assemble the MBE total (and derivatives) from per-fragment results.

    fragments: PhysicalFragment list aligned with `polymers` rows (for cap
    redistribution maps). gradients[i] is (n_total_i, 3) in FRAGMENT
    coordinates; hessians[i] is (3m, 3m); dipole_derivatives[i] is (3, 3m).
    """
    F = polymers.shape[0]
    levels = polymer_levels(polymers)
    if max_level is None:
        max_level = int(levels.max(initial=1))
    N = sys_geom.n_atoms

    weights = mbe_weights(polymers)
    deltas = mbe_deltas(polymers, energies)

    total_energy = float((weights * energies).sum())
    sum_by_level = np.zeros(max_level)
    for lvl in range(1, max_level + 1):
        sel = levels == lvl
        sum_by_level[lvl - 1] = deltas[sel].sum()

    result = MbeResult(
        total_energy=total_energy,
        fragment_energies=np.asarray(energies, dtype=float),
        delta_energies=deltas,
        fragment_distances=(
            np.asarray(distances, dtype=float) if distances is not None else None
        ),
        sum_by_level=sum_by_level,
    )

    if gradients is not None:
        grad = np.zeros((N, 3))
        for i in range(F):
            if weights[i] == 0:
                continue
            redistribute_gradient(
                fragments[i], np.asarray(gradients[i]), grad, scale=float(weights[i])
            )
        result.gradient = grad

    if hessians is not None:
        hess = np.zeros((3 * N, 3 * N))
        for i in range(F):
            if weights[i] == 0:
                continue
            redistribute_hessian(
                fragments[i], np.asarray(hessians[i]), hess, scale=float(weights[i])
            )
        result.hessian = hess

    if dipoles is not None:
        result.dipole = (weights[:, None] * np.asarray(dipoles)).sum(axis=0)

    if dipole_derivatives is not None:
        dmu = np.zeros((3, 3 * N))
        for i in range(F):
            if weights[i] == 0:
                continue
            redistribute_dipole_derivatives(
                fragments[i],
                np.asarray(dipole_derivatives[i]),
                dmu,
                scale=float(weights[i]),
            )
        result.dipole_derivatives = dmu

    return result
