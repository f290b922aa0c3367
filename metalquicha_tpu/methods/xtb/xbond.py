"""GFN1 halogen-bond correction.

The reference gets this through tblite's GFN1 calculator (halogen
correction container; capability surfaced via the `xbond` element constants
in the parameter schema). Functional form: for every halogen X (Cl, Br, I)
covalently bound to a neighbor A, and every donor atom D (N, O, P, S), a
Lennard-Jones-like damped radial factor favoring the sigma-hole distance
with an angular factor favoring linear A-X...D arrangements:

    E_XB = sum_XD  k_X * fangl(theta_AXD) * (t12 - damp * t6) / (1 + t12)
    t6 = (rscale * (Rcov_X + Rcov_D) / R_XD)^6,  t12 = t6^2
    fangl = ((1 - cos theta) / 2)^6

with damp = 0.44 and rscale = 1.3 (GFN1 global constants). The covalent
neighbor A is the nearest atom to X (discrete choice, stop-gradient).
No reference validation targets exercise this term; magnitudes follow the
published GFN1 constants with per-element k_X from the parameter table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

XB_DAMP = 0.44
XB_RSCALE = 1.3

#: donor elements (N, O, P, S + heavier chalcogen/pnictogen analogs)
DONOR_Z = (7, 8, 15, 16, 33, 34, 51, 52)


def halogen_bond_energy(coords, numbers, xbond_strength, rcov, atom_mask):
    """Halogen-bond correction energy (scalar, differentiable in coords).

    xbond_strength: (nat,) per-atom k_X (zero for non-halogens).
    rcov: (nat,) covalent radii in Bohr (the CN radii set).
    """
    nat = coords.shape[0]
    diff = coords[:, None, :] - coords[None, :, :]
    eye = jnp.eye(nat, dtype=coords.dtype)
    r = jnp.sqrt((diff**2).sum(-1) + eye)

    is_x = (xbond_strength > 0.0) & (atom_mask > 0.5)
    is_d = jnp.isin(numbers, jnp.asarray(DONOR_Z)) & (atom_mask > 0.5)

    # covalent neighbor of each X: nearest other real atom
    big = 1.0e6
    r_nn = r + eye * big
    r_nn = jnp.where(atom_mask[None, :] > 0.5, r_nn, big)
    nn = jax.lax.stop_gradient(jnp.argmin(r_nn, axis=1))  # (nat,)

    a_pos = coords[nn]                         # neighbor position per X
    # vectors for the A-X...D angle at X
    xa = a_pos[:, None, :] - coords[:, None, :]            # X->A (nat,1,3)
    xd = coords[None, :, :] - coords[:, None, :]           # X->D (nat,nat,3)
    na = jnp.sqrt((xa**2).sum(-1) + 1e-30)
    nd = jnp.sqrt((xd**2).sum(-1) + 1e-30)
    cos_t = (xa * xd).sum(-1) / (na * nd)
    fangl = ((1.0 - cos_t) * 0.5) ** 6

    r0 = XB_RSCALE * (rcov[:, None] + rcov[None, :])
    t6 = (r0 / jnp.maximum(r, 1e-2)) ** 6
    t12 = t6 * t6
    frad = (t12 - XB_DAMP * t6) / (1.0 + t12)

    pair = (
        is_x[:, None]
        & is_d[None, :]
        & (jnp.arange(nat)[:, None] != jnp.arange(nat)[None, :])
        & (nn[:, None] != jnp.arange(nat)[None, :])  # donor != own neighbor
    )
    e = jnp.where(pair, xbond_strength[:, None] * fangl * frad, 0.0)
    return e.sum()
