"""Mixed-precision host polish: f32 device results + f64 host polish must
match the all-f64 parity path (VERDICT r4 item 4: an accelerator user's
output energies must match CPU-f64 to 1e-8).

Runs on CPU: force_dtype="f32" makes the device calculator f32 while the
HostPolisher re-evaluates in f64 — the accelerator production
configuration, minus the accelerator.
"""

import numpy as np
import pytest

from metalquicha_tpu.driver import run_calculation
from metalquicha_tpu.io.config import parse_mqc_string

from test_driver import TWO_WATERS_MQC


def _run(driver, **overrides):
    cfg = parse_mqc_string(TWO_WATERS_MQC.format(driver=driver))
    return run_calculation(
        cfg, write_json=False, driver_overrides=overrides
    )[""]


@pytest.mark.parametrize("what", ["Energy", "Gradient"])
def test_polished_f32_matches_f64(what):
    ref = _run(what, force_dtype="f64")
    raw = _run(what, force_dtype="f32", host_polish="off")
    pol = _run(what, force_dtype="f32")

    e_ref = ref.result.total_energy
    # raw f32 sits at ~1e-4; the polish must close it to <=1e-8
    assert abs(pol.result.total_energy - e_ref) < 1e-8
    assert abs(raw.result.total_energy - e_ref) > abs(
        pol.result.total_energy - e_ref
    )
    if what == "Gradient":
        g_ref = np.asarray(ref.result.gradient)
        g_pol = np.asarray(pol.result.gradient)
        assert np.abs(g_pol - g_ref).max() < 1e-8


def test_polished_f32_matches_f64_gfn2():
    """GFN2: the polish refines the packed AES state (shell charges +
    atomic dipoles/quadrupoles) via engine.scf_refine_multipole."""
    mqc = TWO_WATERS_MQC.format(driver="Gradient").replace(
        "XTB-GFN1", "XTB-GFN2"
    )
    cfg = parse_mqc_string(mqc)
    ref = run_calculation(
        cfg, write_json=False, driver_overrides={"force_dtype": "f64"}
    )[""]
    pol = run_calculation(
        cfg, write_json=False, driver_overrides={"force_dtype": "f32"}
    )[""]
    assert abs(pol.result.total_energy - ref.result.total_energy) < 1e-8
    g_ref = np.asarray(ref.result.gradient)
    g_pol = np.asarray(pol.result.gradient)
    assert np.abs(g_pol - g_ref).max() < 1e-8


def test_polished_hessian_matches_f64():
    mqc = TWO_WATERS_MQC.format(driver="Hessian").replace("level = 2",
                                                          "level = 1")
    cfg = parse_mqc_string(mqc)
    ref = run_calculation(
        cfg, write_json=False, driver_overrides={"force_dtype": "f64"}
    )[""]
    pol = run_calculation(
        cfg, write_json=False, driver_overrides={"force_dtype": "f32"}
    )[""]
    h_ref = np.asarray(ref.result.hessian)
    h_pol = np.asarray(pol.result.hessian)
    n_ref = float(np.sqrt((h_ref**2).sum()))
    n_pol = float(np.sqrt((h_pol**2).sum()))
    # FD Hessians difference polished GRADIENTS, whose error is first
    # order in the post-polish charge residual — the warm-started f64
    # solve in the q_init path (POLISH_SCF_TOL) is what keeps these
    # tight: with the old fixed-k damped refine the frequency deviation
    # was 0.14 cm^-1 (w1_vib_therm, f32 device leg); with the warm solve
    # it is ~5e-4 cm^-1. Raw f32 was off by 0.25 on the norm.
    assert abs(n_pol - n_ref) < 1e-7
    if ref.vibrational is not None and pol.vibrational is not None:
        f_ref = np.sort(np.asarray(ref.vibrational.frequencies))[-3:]
        f_pol = np.sort(np.asarray(pol.vibrational.frequencies))[-3:]
        assert np.abs(f_pol - f_ref).max() < 0.01  # cm^-1


def _water_frags(n):
    from metalquicha_tpu.constants import ANGSTROM_TO_BOHR

    w = np.array(
        [[0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]]
    ) * ANGSTROM_TO_BOHR
    rng = np.random.default_rng(7)
    return [
        (np.array([8, 1, 1]),
         w + rng.normal(0, 0.05, (1, 3)) + np.array([[6.0 * i, 0, 0]]),
         0, 1)
        for i in range(n)
    ]


def test_rescue_resolves_unconverged_f32_fragments():
    """rescue_tol: fragments whose f32 SCC misses the gate are re-solved
    in full f64 on the host (executor._run_chunk -> HostPolisher.rescue).

    An impossibly tight gate forces EVERY fragment down the rescue path,
    so the executor's output must equal the all-f64 calculator's exactly
    (rescue IS the f64 path)."""
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.polish import HostPolisher
    from metalquicha_tpu.parallel.executor import FragmentExecutor

    frags = _water_frags(3)
    calc32 = XtbCalculator(dtype=jnp.float32)
    ex = FragmentExecutor(
        calc32, polisher=HostPolisher(calc32), rescue_tol=1e-30
    )
    e, g, aux = ex.run(frags, what="gradient")

    calc64 = XtbCalculator(dtype=jnp.float64)
    ex64 = FragmentExecutor(calc64)
    e64, g64, _ = ex64.run(frags, what="gradient")

    assert np.abs(np.asarray(e) - np.asarray(e64)).max() < 1e-12
    for a, b in zip(g, g64):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    # the rescue reports the f64 residuals it actually converged to
    assert float(np.abs(aux["scf_residual"]).max()) < 1e-8
    # ... and counts every fragment it re-solved
    assert ex.n_rescued == ex.n_evaluated == len(frags)


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "raw"])
def test_device_unconverged_count_reads_device_residual(polish):
    """n_device_unconverged counts the device SCC's own residuals, read
    before the polish replaces them: a fragment the device left
    unconverged is counted even when the f64 polish then converges it
    (and the rescue, which reads the polished residual, is not needed)."""
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.methods.xtb.polish import HostPolisher
    from metalquicha_tpu.parallel.executor import FragmentExecutor

    calc32 = XtbCalculator(dtype=jnp.float32)
    energies = calc32.energies

    def planted(frag):
        e, aux = energies(frag)
        res = np.array(aux["scf_residual"])
        res[1] = 1.0  # fragment 1: the device SCC "failed"
        return e, dict(aux, scf_residual=res)

    calc32.energies = planted
    ex = FragmentExecutor(
        calc32, polisher=HostPolisher(calc32) if polish else None,
        rescue_tol=1e-5,
    )
    _, aux = ex.run(_water_frags(3), what="energy")
    assert ex.n_evaluated == 3
    assert ex.n_device_unconverged == 1
    assert ex.n_rescued == 0
    if polish:
        assert float(aux["scf_residual"].max()) < 1e-8
    else:
        assert aux["scf_residual"][1] == 1.0
