"""f64 host polish of f32-device fragment results (mixed precision).

On an accelerator the SCC runs in float32, which leaves raw energies
1e-4..4e-3 Ha off the f64 parity path. The energy functional is
VARIATIONAL in the shell charges, so an O(eps) f32 charge error costs
only O(eps^2) energy error when the functional is re-evaluated in f64 at
the refined charges. Gradients are only FIRST order in the remaining
charge residual (stationarity holds exactly at q*, not near it), and FD
Hessians divide that error by the displacement step — so the polish
warm-starts the full f64 Anderson solve from the f32 state
(single_point_energy q_init path) and runs it to POLISH_SCF_TOL, putting
polished gradients at the all-f64 path's own residual scale. That makes
FD Hessians and frequencies f64-accurate too, since the driver assembles
them from these gradients.

The reference has no analog: its results are f64 everywhere
(the reference's src/methods/mqc_method_xtb.f90); this module is what
makes the port's results independent of the execution platform.

Process model: the device does the SCC iteration work in f32; the host
CPU pays a warm-started f64 solve + one functional (or gradient)
evaluation per fragment, batched with vmap. Both platforms live in one
process (an accelerator platform next to "cpu" in ``jax_platforms``, x64
enabled, an explicitly-f32 device calculator — runtime.configure_runtime).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .calculator import XtbCalculator, single_point_energy

#: differentiable refine-tail steps AFTER the warm-started f64 Anderson
#: solve (single_point_energy re-solves to calc64's scf_tol from the f32
#: state, so the tail only reports the true post-solve residual; 2 is the
#: minimum the q_init path uses).
POLISH_ITERS = 2

#: early-exit tolerance for the polisher's warm-started f64 solve. FD
#: Hessians difference polished gradients, whose error is FIRST order in
#: the charge residual (stationarity holds only exactly at q*), divided by
#: the 0.005 Bohr step — a 1e-7 residual shows up as ~0.1 cm^-1 frequency
#: noise. 1e-11 puts the polish at the all-f64 path's own residual scale;
#: the warm start makes the extra Anderson iterations cheap.
POLISH_SCF_TOL = 1e-11


def host_polish_available() -> bool:
    """True when a CPU backend exists next to the default device."""
    try:
        return len(jax.devices("cpu")) > 0
    except RuntimeError:
        return False


class HostPolisher:
    """Re-evaluates fragment observables in f64 on the host CPU.

    Built from the device calculator so variant/settings/solvation stay
    identical; only dtype and device placement differ (SP2 is f32-only, so
    the polish always does exact f64 eighs).
    """

    def __init__(self, device_calc: XtbCalculator, k: int = POLISH_ITERS):
        self.k = int(k)
        self.cpu = jax.devices("cpu")[0]
        settings = device_calc.settings
        # tighten the early-exit: the device calculator's tol is scaled for
        # f32; the polish's warm-started f64 solve must go to ~machine
        # residual (see POLISH_SCF_TOL). scf_tol == 0.0 (fixed-iteration
        # semantics, runs the full budget) is already at least as tight.
        if settings.scf_tol and settings.scf_tol > POLISH_SCF_TOL:
            settings = settings._replace(scf_tol=POLISH_SCF_TOL)
        self.calc64 = XtbCalculator(
            settings=settings,
            variant=device_calc.variant,
            dtype=jnp.float64,
            solvation=device_calc.solvation,
        )
        self._jits = {}

    def supports(self) -> bool:
        # GFN1 refines the shell-charge vector; GFN2 refines the packed
        # AES state (engine.scf_refine_multipole) — both wired
        return True

    def _fn(self, what: str):
        key = what
        try:
            return self._jits[key]
        except KeyError:
            pass
        settings = self.calc64.settings
        solvation = self.calc64.solvation
        k = self.k

        def e_of(coords, frag, q0):
            return single_point_energy(
                coords, frag, settings, solvation,
                diff_scf_iters=k, q_init=q0,
            )

        if what == "energy":
            fn = jax.jit(jax.vmap(e_of))
        else:
            def e_and_g(coords, frag, q0):
                (e, aux), g = jax.value_and_grad(
                    e_of, argnums=0, has_aux=True
                )(coords, frag, q0)
                return e, g, aux

            fn = jax.jit(jax.vmap(e_and_g))
        self._jits[key] = fn
        return fn

    def rescue(self, tuples, pad_to, what: str):
        """FULL f64 host SCC for fragments whose f32 device SCC failed.

        The polish warm-starts its f64 solve from the f32 state; a
        diverged device SCC (slow-contracting fragments — GMBE
        coincident-cap intersections, highly charged clusters — can
        oscillate in f32) hands it a garbage warm start that may burn the
        whole bounded budget and still miss tolerance. Those fragments are
        re-solved from scratch (zeros start) in f64 on the host with the
        full iteration budget, exactly like the CPU parity path. The batch
        is padded to a fixed quantum so repeated rescues of 1-2 stragglers
        reuse one compiled program per bucket shape.
        """
        RESCUE_PAD = 8
        dummy = (np.array([1]), np.zeros((1, 3)), 0, 2)
        n_real = len(tuples)
        tuples = list(tuples) + [dummy] * ((-n_real) % RESCUE_PAD)
        frag = self.calc64.make_batch(tuples, pad_to=pad_to)
        frag = jax.device_put(frag, self.cpu)
        if what == "gradient":
            e, g, aux = self.calc64.gradients(frag)
        else:
            e, aux = self.calc64.energies(frag)
            g = None
        e = np.asarray(e)[:n_real]
        g = np.asarray(g)[:n_real] if g is not None else None
        aux = {
            k: np.asarray(v)[:n_real]
            for k, v in aux.items()
        }
        return e, g, aux

    def polish(self, tuples, pad_to, shell_charges, what: str):
        """Polished (energies[, gradients], aux) for one padded chunk.

        tuples/pad_to are the executor's host-side batch description;
        shell_charges is the device aux['shell_charges'] (f32, same
        shell padding as the chunk).
        """
        frag = self.calc64.make_batch(tuples, pad_to=pad_to)
        frag = jax.device_put(frag, self.cpu)
        q0 = jax.device_put(
            jnp.asarray(np.asarray(shell_charges), dtype=jnp.float64),
            self.cpu,
        )
        fn = self._fn(what)
        if what == "gradient":
            e, g, aux = fn(frag.coords, frag, q0)
            return e, g, aux
        e, aux = fn(frag.coords, frag, q0)
        return e, None, aux
