"""Central finite differences as batched displacement sweeps.

The reference generates all 3N +/- displaced geometries and assembles
H[i,j] = (g_j(+h) - g_j(-h)) / 2h, then symmetrizes
(/root/reference/src/utils/mqc_finite_differences.f90:31-201). Here the 6N
displaced geometries form ONE batch axis — the batched version of its
displacement-parallel distributed Hessian (P2 scheme).
"""

from __future__ import annotations

import numpy as np


def displaced_geometries(coords: np.ndarray, displacement: float) -> np.ndarray:
    """(6N, N, 3) array: [+h, -h] for each of the 3N coordinates.

    Ordering: index 2*(3*a+d) is +h on atom a, axis d; 2*(3*a+d)+1 is -h.
    """
    n = coords.shape[0]
    out = np.repeat(coords[None, :, :], 6 * n, axis=0)
    for a in range(n):
        for d in range(3):
            i = 3 * a + d
            out[2 * i, a, d] += displacement
            out[2 * i + 1, a, d] -= displacement
    return out


def hessian_from_gradients(gradients: np.ndarray, displacement: float) -> np.ndarray:
    """Assemble the symmetrized Hessian from gradients at displaced geometries.

    gradients: (6N, N, 3) matching `displaced_geometries` ordering.
    Returns (3N, 3N).
    """
    six_n = gradients.shape[0]
    n3 = six_n // 2
    g = gradients.reshape(six_n, n3)
    h = np.zeros((n3, n3))
    for i in range(n3):
        h[i, :] = (g[2 * i] - g[2 * i + 1]) / (2.0 * displacement)
    return 0.5 * (h + h.T)


def dipole_derivatives_from_dipoles(
    dipoles: np.ndarray, displacement: float
) -> np.ndarray:
    """(3, 3N) d mu_k / d x_i from dipoles at displaced geometries (6N, 3)."""
    six_n = dipoles.shape[0]
    n3 = six_n // 2
    out = np.zeros((3, n3))
    for i in range(n3):
        out[:, i] = (dipoles[2 * i] - dipoles[2 * i + 1]) / (2.0 * displacement)
    return out
