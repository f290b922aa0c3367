"""SP2 density-matrix purification — a diagonalization-free SCC step.

Inside the *non-differentiated* SCC fixed-point loop (engine.scf_solve)
eigenpairs are never needed — only the density matrix that generates the
shell populations. The second-order spectral projection (SP2) recursion of
Niklasson [PRB 66, 155115 (2002)] builds the zero-temperature density
projector from ~30-60 *batched matmuls*:

    X_0     = (emax I - F) / (emax - emin)          # spectrum -> [0, 1]
    X_{n+1} = X_n^2             if tr(X_n^2) closer to Nocc
            = 2 X_n - X_n^2     otherwise

Each iteration is ONE (B, N, N) matmul plus elementwise selects, so its
cost scales with matmul throughput instead of eigensolver latency. Whether
that beats the batched eigh on a given device is a measurement
(`chip_smoke.py` times both density builds).

Validity: SP2 yields the T=0 projector (integer occupations). The
production SCC runs Fermi smearing at 300 K, where kT ~ 9.5e-4 Ha; for
closed-shell fragments with a HOMO-LUMO gap above ~1 eV the smeared and
T=0 fixed points agree to <1e-10 Ha (one of the CLI's rotating
knowledge-level exit facts, logging_._KNOWLEDGE). The final
variational energy evaluation ALWAYS goes through the true eigh —
SP2 only accelerates the charge self-consistency iterations (engine.py
gate: `inloop_sp2` for AO dims above `SP2_MIN_NAO`, f32 only).

Reference parity note: tblite/the reference diagonalize with LAPACK
sygvd inside their SCC (mqc_method_xtb.f90 delegating to tblite); the
fixed point is solver-independent, so replacing the in-loop solver is a
performance choice, not a physics change.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("iters",))
def sp2_projector(Fo, nocc, ao_mask, iters: int = 48):
    """T=0 density projector of a symmetric (orthogonalized) Fock matrix.

    Fo:      (..., N, N) symmetric, in an orthonormal basis.
    nocc:    (...,) number of occupied states (traced; float).
    ao_mask: (..., N) 1.0 for real AOs, 0.0 for padding. Padded states are
             pinned at the top of the spectrum (never occupied).
    Returns (..., N, N) projector P with P^2 = P, tr(P) = nocc, spanning
    the nocc lowest eigenvectors of Fo.
    """
    n = Fo.shape[-1]
    eye = jnp.eye(n, dtype=Fo.dtype)
    pair = ao_mask[..., :, None] * ao_mask[..., None, :]
    Fo = Fo * pair

    # Gershgorin bounds over the REAL block only (padded rows are zeroed;
    # padding at +100 Ha would otherwise stretch the [0,1] map ~50x and
    # stall convergence, which is gap/(emax-emin)-limited).
    diag = jnp.diagonal(Fo, axis1=-2, axis2=-1)
    offsum = jnp.sum(jnp.abs(Fo), axis=-1) - jnp.abs(diag)
    big = jnp.asarray(1e30, Fo.dtype)
    lo = jnp.min(jnp.where(ao_mask > 0, diag - offsum, big), axis=-1)
    hi = jnp.max(jnp.where(ao_mask > 0, diag + offsum, -big), axis=-1)
    width = jnp.maximum(hi - lo, 1e-6)

    # map spectrum to [0, 1] (occupied -> near 1); padded diagonal -> 0
    X = (hi[..., None, None] * eye - Fo) / width[..., None, None]
    X = jnp.where(pair > 0, X, 0.0)

    def body(_, X):
        X2 = X @ X
        tr2 = jnp.trace(X2, axis1=-2, axis2=-1)
        tr = jnp.trace(X, axis1=-2, axis2=-1)
        # branch-free Niklasson criterion: pick whichever recursion moves
        # the trace toward nocc
        take_sq = jnp.abs(tr2 - nocc) < jnp.abs(2.0 * tr - tr2 - nocc)
        return jnp.where(take_sq[..., None, None], X2, 2.0 * X - X2)

    return jax.lax.fori_loop(0, iters, body, X)


def sp2_density(Fo, nelec, nuhf, ao_mask, iters: int = 48):
    """Spin-summed T=0 density matrix in the orthonormal basis.

    Closed shell (nuhf == 0): P = 2 * proj(nelec / 2). Open shell: the
    spin-restricted fractional-occupation convention the engine uses
    (na/nb split) maps to proj(na) + proj(nb).
    """
    na = (nelec + nuhf) * 0.5
    nb = (nelec - nuhf) * 0.5
    Pa = sp2_projector(Fo, na, ao_mask, iters=iters)
    # closed shell is the overwhelmingly common case in MBE fragment
    # batches; skip the second recursion there (same projector)
    both_same = jnp.all(nuhf == 0)

    def closed(_):
        return 2.0 * Pa

    def open_(_):
        return Pa + sp2_projector(Fo, nb, ao_mask, iters=iters)

    return jax.lax.cond(both_same, closed, open_, None)
