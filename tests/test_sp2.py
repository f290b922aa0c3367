"""SP2 purification: projector correctness + SCC fixed-point agreement.

The SP2 recursion (ops/sp2.py) replaces the in-loop eigensolver on the
f32 path when `inloop_sp2` is set, for AO dims above SP2_MIN_NAO. These
tests check the projector against eigh (with padding and open shells)
and that an SCC driven by SP2 densities lands on the same converged
charges as the eigh-driven loop.
"""

import numpy as np
import pytest


def _gapped_symmetric(rng, n, nocc, gap=0.5, dtype=np.float64):
    """Random symmetric matrix with a controlled HOMO-LUMO gap."""
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lo = np.sort(rng.uniform(-2.0, -1.0, size=nocc))
    hi = np.sort(rng.uniform(-1.0 + gap, 1.0, size=n - nocc))
    w = np.concatenate([lo, hi])
    return (q * w[None, :]) @ q.T, w, q


def _eigh_projector(a, nocc):
    _, v = np.linalg.eigh(a)
    occ = v[:, :nocc]
    return occ @ occ.T


def test_sp2_projector_matches_eigh():
    import jax.numpy as jnp

    from metalquicha_tpu.ops.sp2 import sp2_projector

    rng = np.random.default_rng(7)
    n, nocc = 24, 9
    a, _, _ = _gapped_symmetric(rng, n, nocc)
    mask = np.ones(n)
    p = np.asarray(
        sp2_projector(jnp.asarray(a), jnp.asarray(float(nocc)), jnp.asarray(mask))
    )
    p_ref = _eigh_projector(a, nocc)
    np.testing.assert_allclose(p, p_ref, atol=1e-9)
    assert abs(np.trace(p) - nocc) < 1e-9
    # idempotency
    assert np.abs(p @ p - p).max() < 1e-9


def test_sp2_projector_respects_padding():
    """Padded AOs must stay empty and not perturb the real block."""
    import jax.numpy as jnp

    from metalquicha_tpu.ops.sp2 import sp2_projector

    rng = np.random.default_rng(3)
    n_real, n_pad, nocc = 18, 14, 7
    n = n_real + n_pad
    a_real, _, _ = _gapped_symmetric(rng, n_real, nocc)
    a = np.zeros((n, n))
    a[:n_real, :n_real] = a_real
    # padded diagonal at +100 Ha like the engine's padded shells
    a[np.arange(n_real, n), np.arange(n_real, n)] = 100.0
    mask = np.concatenate([np.ones(n_real), np.zeros(n_pad)])
    p = np.asarray(
        sp2_projector(jnp.asarray(a), jnp.asarray(float(nocc)), jnp.asarray(mask))
    )
    np.testing.assert_allclose(
        p[:n_real, :n_real], _eigh_projector(a_real, nocc), atol=1e-9
    )
    assert np.abs(p[n_real:, :]).max() < 1e-12
    assert np.abs(p[:, n_real:]).max() < 1e-12


def test_sp2_density_open_shell_and_batch():
    import jax.numpy as jnp

    from metalquicha_tpu.ops.sp2 import sp2_density

    rng = np.random.default_rng(11)
    n = 16
    a, _, _ = _gapped_symmetric(rng, n, 5, gap=0.4)
    mask = np.ones(n)

    # closed shell, 10 electrons -> 2 * proj(5)
    p_cs = np.asarray(
        sp2_density(jnp.asarray(a), jnp.asarray(10.0), jnp.asarray(0.0),
                    jnp.asarray(mask))
    )
    np.testing.assert_allclose(p_cs, 2.0 * _eigh_projector(a, 5), atol=1e-9)

    # doublet, 9 electrons, nuhf=1 -> proj(5) + proj(4)
    p_os = np.asarray(
        sp2_density(jnp.asarray(a), jnp.asarray(9.0), jnp.asarray(1.0),
                    jnp.asarray(mask))
    )
    np.testing.assert_allclose(
        p_os, _eigh_projector(a, 5) + _eigh_projector(a, 4), atol=1e-9
    )


def test_sp2_scc_matches_eigh_fixed_point(monkeypatch):
    """Full SCC on water (f32): SP2-driven charges == eigh-driven charges.

    Forces the SP2 gate by lowering SP2_MIN_NAO below water's AO count,
    so this is the exact code path large f32 fragments take.
    """
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.constants import ANGSTROM_TO_BOHR
    from metalquicha_tpu.methods.xtb import engine
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator

    water = (
        np.array([8, 1, 1]),
        np.array([
            [0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]
        ]) * ANGSTROM_TO_BOHR,
        0,
        1,
    )
    calc = XtbCalculator()
    frag = calc.make_batch([water])
    frag32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, frag
    )
    kt = calc.settings.electronic_temp * engine.KB_HARTREE
    s_eigh = calc.settings._replace(inloop_sp2=False)
    s_fast = calc.settings._replace(inloop_sp2=True)

    def charges(settings):
        def one(coords, f):
            c = coords * 1.0
            cn = engine.coordination_numbers(
                c, f.at_rcov, f.atom_mask, f.glb[11], settings.cn_type)
            S = engine.overlap_matrix(
                c, f.ao_atom, f.ao_lxyz, f.prim_alpha, f.prim_coeff
            )
            gamma = engine.gamma_matrix(c, f, settings)
            H0 = engine.h0_matrix(S, c, f, cn, settings)
            q, resid = engine.scf_solve(H0, S, gamma, f, kt, settings)
            return q, resid

        return jax.vmap(lambda f: one(f.coords, f))(frag32)

    # SP2 path (gate forced below water's 6 AOs)
    monkeypatch.setattr(engine, "SP2_MIN_NAO", 2)
    q_sp2, r_sp2 = charges(s_fast)
    q_ref, r_ref = charges(s_eigh)
    assert float(r_ref.max()) < 1e-5
    assert float(r_sp2.max()) < 1e-5
    # T=0 projector vs 300 K smearing: identical for gapped systems up to
    # f32 SCC noise (two different solvers; the canonical-orthogonalization
    # eigh route and the SP2 route each carry ~1e-5-level f32 jitter)
    np.testing.assert_allclose(
        np.asarray(q_sp2), np.asarray(q_ref), atol=1e-4
    )


def test_sp2_gate_disabled_for_d_block_and_open_shell(monkeypatch):
    """The calculator must not route d-block or open-shell batches to SP2.

    SP2's T=0 integer-occupation projector diverges from the production
    300 K smeared fixed point exactly where partially-filled d levels make
    the gap small (ADVICE r3). The per-batch settings gate swaps in the
    exact in-loop eigensolver for those batches; gapped closed-shell
    main-group batches keep the fast path.
    """
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb import engine
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.engine import settings_from_params

    calc = XtbCalculator(
        settings_from_params("gfn1", inloop_sp2=True),
        dtype=jnp.float32,
    )
    # force every batch above the threshold so SP2 would be selected
    monkeypatch.setattr(engine, "SP2_MIN_NAO", 2)

    water = (np.array([8, 1, 1]), np.array(
        [[0.0, 0.0, 0.0], [0.0, 1.43, 1.1], [0.0, -1.43, 1.1]]), 0, 1)
    closed = calc.make_batch([water])
    assert calc._settings_for(closed).inloop_sp2 is True

    tio = (np.array([22, 8]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.1]]),
           0, 1)
    d_block = calc.make_batch([tio])
    assert calc._settings_for(d_block).inloop_sp2 is False

    doublet = (np.array([8, 1]), np.array(
        [[0.0, 0.0, 0.0], [0.0, 0.0, 1.83]]), 0, 2)
    open_shell = calc.make_batch([doublet])
    assert calc._settings_for(open_shell).inloop_sp2 is False

    # at or below the threshold the in-loop eigh runs and the knob stays
    monkeypatch.setattr(engine, "SP2_MIN_NAO", 64)
    assert calc._settings_for(d_block).inloop_sp2 is True
