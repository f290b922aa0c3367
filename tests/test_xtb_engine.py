"""xTB engine tests: integrals, SCF invariants, autodiff gradients.

These validate the ENGINE (forms, convergence, derivatives, batching) —
numeric parity of the parameterization against the reference energies is
exercised separately by the validation harness.
"""

import jax
import numpy as np
import pytest

from metalquicha_tpu.constants import ANGSTROM_TO_BOHR
from metalquicha_tpu.methods.xtb.basis import slater_to_gauss
from metalquicha_tpu.methods.xtb.calculator import (
    XtbCalculator,
    fragment_data_from_batch,
)
from metalquicha_tpu.methods.xtb.batch import build_batch, element_basis

WATER = (
    np.array([8, 1, 1]),
    np.array([[0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]])
    * ANGSTROM_TO_BOHR,
    0,
    1,
)


@pytest.fixture(scope="module")
def calc():
    return XtbCalculator()


@pytest.fixture(scope="module")
def water_result(calc):
    frag = calc.make_batch([WATER])
    e, aux = calc.energies(frag)
    return frag, e, aux


def test_sto_ng_fit_quality():
    """Tabulated STO-nG expansions must reproduce the STO radial function."""

    def quality(ng, n, l, zeta=1.3):
        import math

        r = np.linspace(1e-6, 30, 100001)
        nfac = (2 * zeta) ** (n + 0.5) / math.sqrt(math.factorial(2 * n))
        sto = nfac * r ** (n - 1) * np.exp(-zeta * r)
        al, co = slater_to_gauss(ng, n, l, zeta)
        cg = np.zeros_like(r)
        for a, c in zip(al, co):
            df = 1.0
            k = 2 * l - 1
            while k > 1:
                df *= k
                k -= 2
            nn = (2 * a / math.pi) ** 0.75 * (4 * a) ** (l / 2) / math.sqrt(df)
            cg += c * nn * r**l * np.exp(-a * r * r)
        s12 = np.trapezoid(sto * cg * r * r, r)
        s22 = np.trapezoid(cg * cg * r * r, r)
        return s12 / np.sqrt(s22)

    assert quality(6, 1, 0) > 0.99999
    assert quality(6, 2, 0) > 0.99999
    assert quality(6, 2, 1) > 0.99999
    assert quality(3, 1, 0) > 0.9998
    assert quality(4, 1, 0) > 0.9999


def test_overlap_symmetric_normalized(calc, water_result):
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.overlap import overlap_matrix

    frag_b, _, _ = water_result
    frag = jax.tree.map(lambda x: x[0], frag_b)
    S = overlap_matrix(
        frag.coords, frag.ao_atom, frag.ao_lxyz, frag.prim_alpha, frag.prim_coeff
    )
    S = np.asarray(S)
    np.testing.assert_allclose(S, S.T, atol=1e-14)
    np.testing.assert_allclose(np.diag(S), 1.0, atol=1e-12)
    # eigenvalues positive (S positive definite)
    assert np.linalg.eigvalsh(S).min() > 0.1


def test_scf_converges_and_conserves_charge(water_result):
    _, e, aux = water_result
    assert float(aux["scf_residual"][0]) < 1e-10
    assert abs(float(aux["charges"].sum())) < 1e-10
    assert -7.0 < float(e[0]) < -4.0  # sane GFN1 water ballpark


def test_cation_charge_conserved(calc):
    h3o = (
        np.array([8, 1, 1, 1]),
        np.array(
            [
                [1.0925940942, -0.1960118985, 0.1054113976],
                [2.0700171780, -0.0708506168, 0.0091166421],
                [0.7807135018, -0.4182867270, -0.8074994503],
                [0.7408717471, 0.7134153793, 0.2734643830],
            ]
        )
        * ANGSTROM_TO_BOHR,
        1,
        1,
    )
    frag = calc.make_batch([h3o])
    e, aux = calc.energies(frag)
    assert float(aux["scf_residual"][0]) < 1e-10
    assert abs(float(aux["charges"].sum()) - 1.0) < 1e-10


def test_ad_gradient_matches_fd(calc):
    frag = calc.make_batch([WATER])
    _, g, _ = calc.gradients(frag)
    g = np.asarray(g[0])[:3]
    h = 1e-5
    numbers, coords, charge, mult = WATER
    for a in range(3):
        for d in range(3):
            cp = coords.copy()
            cp[a, d] += h
            cm = coords.copy()
            cm[a, d] -= h
            ep = calc.energies(calc.make_batch([(numbers, cp, charge, mult)]))[0][0]
            em = calc.energies(calc.make_batch([(numbers, cm, charge, mult)]))[0][0]
            fd = (float(ep) - float(em)) / (2 * h)
            assert abs(g[a, d] - fd) < 5e-8, (a, d, g[a, d], fd)


def test_translation_rotation_invariance(calc, water_result):
    _, e0, _ = water_result
    numbers, coords, charge, mult = WATER
    # translation
    ft = calc.make_batch([(numbers, coords + 7.3, charge, mult)])
    assert abs(float(calc.energies(ft)[0][0] - e0[0])) < 1e-11
    # rotation about z by 0.3 rad
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    fr = calc.make_batch([(numbers, coords @ R.T, charge, mult)])
    assert abs(float(calc.energies(fr)[0][0] - e0[0])) < 1e-11


def test_padding_invariance(calc, water_result):
    _, e0, _ = water_result
    fp = calc.make_batch([WATER], pad_to=(9, 18, 24))
    assert abs(float(calc.energies(fp)[0][0] - e0[0])) < 1e-11


def test_batching_matches_single(calc):
    """A heterogeneous batch must reproduce per-fragment energies."""
    numbers, coords, charge, mult = WATER
    h2 = (np.array([1, 1]), np.array([[0.0, 0, 0], [1.4, 0, 0]]), 0, 1)
    fb = calc.make_batch([WATER, h2])
    eb, _ = calc.energies(fb)
    e1 = calc.energies(calc.make_batch([WATER], pad_to=(3, 6, 8)))[0][0]
    # pad h2 to the same bucket as the batch for identical shapes
    nat, nsh, nao = fb.coords.shape[1], fb.sh_mask.shape[1], fb.ao_mask.shape[1]
    e2 = calc.energies(calc.make_batch([h2], pad_to=(nat, nsh, nao)))[0][0]
    assert abs(float(eb[0]) - float(e1)) < 1e-11
    assert abs(float(eb[1]) - float(e2)) < 1e-11


def test_element_basis_ao_counts():
    assert element_basis(1).n_ao == 2  # H: 1s + 2s
    assert element_basis(8).n_ao == 4  # O: 2s + 2p
    assert element_basis(6).n_shells == 2


def test_h_2s_orthogonalized():
    """H's polarization 2s must be orthogonal to its 1s after basis setup."""
    eb = element_basis(1)
    a1, c1 = eb.prim_alpha[0], eb.prim_coeff[0]
    a2, c2 = eb.prim_alpha[1], eb.prim_coeff[1]
    ai = a1[:, None]
    aj = a2[None, :]
    s = (2.0 * np.sqrt(ai * aj) / (ai + aj)) ** 1.5
    assert abs(c1 @ s @ c2) < 1e-12


def test_angular_grids_exactness():
    """Exact small Lebedev rules + spectrally-exact product grids."""
    import numpy as np

    from metalquicha_tpu.methods.xtb.solvation.grids import angular_grid

    for n, deg in ((6, 3), (14, 5), (26, 7), (38, 9), (50, 11)):
        pts, w = angular_grid(n)
        assert len(w) == n
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-14)
        np.testing.assert_allclose(pts[:, 0] ** 2 @ w, 1 / 3, atol=1e-13)
        if deg >= 9:
            np.testing.assert_allclose(pts[:, 0] ** 8 @ w, 1 / 9, atol=1e-13)
    # reconstructed Lebedev rules (tools/gen_lebedev.py): exactly-sized,
    # exact to their full algebraic degree
    def dfact(k):
        out = 1.0
        while k > 1:
            out *= k
            k -= 2
        return out

    for n, deg in ((74, 13), (86, 15), (110, 17), (146, 19), (170, 21),
                   (194, 23), (230, 25), (302, 29)):
        pts, w = angular_grid(n)
        assert len(w) == n, f"order {n} should be a true Lebedev rule"
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-12)
        for i, j, k in ((deg // 2, 0, 0), (3, 2, 1), (2, 2, 2)):
            if 2 * (i + j + k) > deg:
                continue
            exact = (
                dfact(2 * i - 1) * dfact(2 * j - 1) * dfact(2 * k - 1)
                / dfact(2 * (i + j + k) + 1)
            )
            got = (
                pts[:, 0] ** (2 * i) * pts[:, 1] ** (2 * j)
                * pts[:, 2] ** (2 * k)
            ) @ w
            np.testing.assert_allclose(got, exact, atol=1e-12)
    # non-tabulated orders fall back to the spectral product grid
    pts, w = angular_grid(1000)
    assert len(w) >= 1000
    np.testing.assert_allclose(pts[:, 2] ** 8 @ w, 1 / 9, atol=1e-13)


def test_cds_and_shift_flags_change_energy():
    """use_cds/use_shift default ON and change the solvated energy in the
    documented direction (mqc_method_xtb.f90:532-554; reference defaults
    mqc_config_parser.F90:80-81)."""
    import numpy as np

    from metalquicha_tpu.constants import ANGSTROM_TO_BOHR
    from metalquicha_tpu.geometry import (
        SystemGeometry,
        build_fragment_from_indices,
    )
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.solvation.born import BornSolvation

    w = SystemGeometry(
        numbers=[8, 1, 1],
        coords=np.array(
            [[0, 0, 0], [0, 0, 0.9572], [0.9239, 0, -0.2399]]
        ) * ANGSTROM_TO_BOHR,
        fragment_atoms=[np.arange(3)],
        fragment_charges=[0],
        fragment_multiplicities=[1],
    )
    fr = build_fragment_from_indices(w, [0])

    def energy(**kw):
        model = BornSolvation(dielectric=80.2, alpb=True, **kw)
        calc = XtbCalculator(variant="gfn1", solvation=model)
        e, _ = calc.energies(calc.make_batch([fr]))
        return float(np.asarray(e)[0])

    e00 = energy(use_cds=False, use_shift=False)
    e10 = energy(use_cds=True, use_shift=False)
    e01 = energy(use_cds=False, use_shift=True)
    e11 = energy(use_cds=True, use_shift=True)
    # defaults are ON
    e_def = energy()
    assert e_def == e11
    # shift adds the positive solution-state correction exactly
    from metalquicha_tpu.methods.xtb.solvation.born import GSHIFT_DEFAULT

    np.testing.assert_allclose(e01 - e00, GSHIFT_DEFAULT, atol=1e-12)
    # CDS is additive and nonzero for a water-sized cavity
    assert abs(e10 - e00) > 1e-4
    np.testing.assert_allclose(e11 - e10, e01 - e00, atol=1e-12)


def test_gfn2_multipole_scc_and_gradients():
    """GFN2 AES path: converges, stationary-functional gradients match FD."""
    import jax
    import numpy as np

    from metalquicha_tpu.constants import ANGSTROM_TO_BOHR
    from metalquicha_tpu.geometry import (
        SystemGeometry,
        build_fragment_from_indices,
    )
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.engine import settings_from_params

    w = SystemGeometry(
        numbers=[8, 1, 1],
        coords=np.array(
            [[0, 0, 0], [0, 0, 0.9572], [0.9239, 0, -0.2399]]
        ) * ANGSTROM_TO_BOHR,
        fragment_atoms=[np.arange(3)],
        fragment_charges=[0],
        fragment_multiplicities=[1],
    )
    fr = build_fragment_from_indices(w, [0])
    calc = XtbCalculator(
        settings_from_params("gfn2", multipoles=True), variant="gfn2"
    )
    fd = calc.make_batch([fr])
    e, g, aux = calc.gradients(fd)
    assert float(np.asarray(aux["scf_residual"])[0]) < 1e-9
    e0 = float(np.asarray(e)[0])
    assert np.isfinite(e0)

    # FD cross-check of one gradient component (AES terms included)
    g0 = np.asarray(g)[0]
    h = 1e-4
    c = np.asarray(fd.coords).copy()
    for (ia, d) in ((1, 2), (0, 0)):
        cp = c.copy()
        cp[0, ia, d] += h
        ep, _ = calc.energies(fd._replace(coords=cp))
        cm = c.copy()
        cm[0, ia, d] -= h
        em, _ = calc.energies(fd._replace(coords=cm))
        fdg = (float(np.asarray(ep)[0]) - float(np.asarray(em)[0])) / (2 * h)
        assert abs(fdg - g0[ia, d]) < 5e-6, (ia, d, fdg, g0[ia, d])


def test_f32_degenerate_dimer_gradient():
    """Identical-monomer dimers must give correct f32 gradients.

    Round-3 regression: two waters with IDENTICAL internal geometry 12 Bohr
    apart produce exactly degenerate eigenvalue pairs across the monomers.
    eigh_safe's old backward kernel g/(g^2+1e-18) was f64-tuned; at f32
    noise-level gaps (~1e-6) it amplified by ~1e6, returning |g| ~43x too
    large while the SCC reported converged (the f32 production path). The
    dtype-aware degeneracy cut must keep f32 within ~1e-3 of f64.
    """
    import jax.numpy as jnp

    numbers, coords, charge, mult = WATER
    z = np.concatenate([numbers, numbers])
    c = np.vstack([coords, coords + np.array([[12.0, 0.0, 0.0]])])
    dimer = (z, c, 0, 1)

    calc64 = XtbCalculator(dtype=jnp.float64)
    _, g64, _ = calc64.gradients(calc64.make_batch([dimer]))
    n64 = float(np.sqrt((np.asarray(g64[0]) ** 2).sum()))

    calc32 = XtbCalculator(dtype=jnp.float32)
    _, g32, aux = calc32.gradients(calc32.make_batch([dimer]))
    n32 = float(np.sqrt((np.asarray(g32[0]) ** 2).sum()))
    resid = float(np.asarray(aux["scf_residual"]).max())

    assert resid < 1e-4, f"f32 SCC did not converge: {resid}"
    assert abs(n32 - n64) < 1e-3, (n32, n64)


def test_q_init_warm_start_matches_cold_scc(calc):
    """single_point_energy(q_init=...) recovers the cold-SCC fixed point.

    The warm-start entry powers the mixed-precision workflow
    (methods/xtb/polish.py): the variational functional is stationary at
    q*, so polishing slightly-perturbed charges with 2 damped steps must
    reproduce the converged energy to second order in the perturbation.
    """
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import single_point_energy

    frag_b = calc.make_batch([WATER])
    e_cold, aux_cold = calc.energies(frag_b)
    e_cold = float(np.asarray(e_cold)[0])

    frag1 = jax.tree.map(lambda x: x[0], frag_b)
    q_star = jnp.asarray(np.asarray(aux_cold["shell_charges"])[0])

    # exact warm start: identical fixed point
    e_warm, aux_warm = single_point_energy(
        frag1.coords, frag1, calc.settings, q_init=q_star, diff_scf_iters=2
    )
    assert float(e_warm) == pytest.approx(e_cold, abs=1e-11)
    assert float(aux_warm["scf_residual"]) < 1e-9

    # f32-noise-scale perturbation: O(eps^2) energy error after polish
    rng = np.random.default_rng(0)
    q_pert = q_star + jnp.asarray(
        1e-4 * rng.normal(size=q_star.shape)
    ) * frag1.sh_mask
    e_p2, _ = single_point_energy(
        frag1.coords, frag1, calc.settings, q_init=q_pert, diff_scf_iters=2
    )
    assert float(e_p2) == pytest.approx(e_cold, abs=1e-8)
    e_p8, _ = single_point_energy(
        frag1.coords, frag1, calc.settings, q_init=q_pert, diff_scf_iters=8
    )
    assert float(e_p8) == pytest.approx(e_cold, abs=1e-10)
