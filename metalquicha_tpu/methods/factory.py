"""Method factory.

Parity with /root/reference/src/methods/mqc_method_factory.F90:42-111:
dispatches on method_type and copies method configuration into the concrete
calculator (electronic temperature, SCF iteration budget, solvation).
"""

from __future__ import annotations

import warnings

from ..io.adapter import DriverConfig, MethodType
from .stubs import DFTMethod, HFMethod, MCSCFMethod
from .xtb.engine import settings_from_params


def create_calculator(drv: DriverConfig):
    mt = drv.method.method_type
    if mt in (MethodType.GFN1, MethodType.GFN2):
        from .xtb.calculator import XtbCalculator

        variant = "gfn1" if mt == MethodType.GFN1 else "gfn2"
        settings = settings_from_params(
            variant,
            max_scf_iter=max(32, min(drv.method.scf.maxiter, 256)),
            # early-exit at a tenth of the user tolerance: well inside the
            # driver's convergence gate (10x tol) yet skipping the dead
            # tail of a 256-iteration budget once fragments are converged
            scf_tol=0.1 * drv.method.scf.tolerance,
            electronic_temp=drv.method.xtb.electronic_temp,
        )
        xtb = drv.method.xtb
        solvation = None
        if xtb.has_solvation():
            from .xtb.solvation import make_solvation_model

            solvation = make_solvation_model(xtb, variant)

        # Working dtype is EXPLICIT, never inferred from the x64 flag:
        # non-CPU backends run f32 with the f64 host polish restoring
        # accuracy (methods/xtb/polish.py), CPU runs f64. The accelerator
        # choice is carried over; f64-on-device vs f32+polish is decided
        # by measurement (ROADMAP design item 2). force_dtype pins it (CLI
        # --f32 / tests).
        import jax
        import jax.numpy as jnp

        fd = getattr(drv, "force_dtype", None)
        if fd:
            dtype = jnp.float32 if fd == "f32" else jnp.float64
        else:
            dtype = (
                jnp.float64
                if jax.default_backend() == "cpu"
                else jnp.float32
            )
        return XtbCalculator(
            settings=settings, variant=variant, solvation=solvation,
            dtype=dtype,
        )
    if mt == MethodType.HF:
        return HFMethod()
    if mt == MethodType.DFT:
        return DFTMethod()
    if mt == MethodType.MCSCF:
        return MCSCFMethod()
    raise NotImplementedError(f"method {mt.name} is not implemented")
