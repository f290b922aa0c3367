"""Calculation driver: orchestrates parse -> fragment -> execute -> assemble
-> output.

Workflow parity with /root/reference/src/mqc_driver.f90:
- nlevel = 0 -> unfragmented path (:147-156)
- MBE: monomer+n-mer enumeration, distance screening, size sort (:285-325)
- GMBE: primaries + PIE enumeration (:228-283)
- multi-molecule: per-molecule runs merged into one JSON (:468-677)

Execution replaces the MPI role split (run_serial/run_distributed) with the
mesh-sharded batch executor; Hessians are batched FD displacement sweeps
(the batched version of the reference's P2 displacement parallelism).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .errors import ConvergenceError, InputError, with_context
from .frag.combinatorics import enumerate_polymers
from .frag.gmbe import compute_gmbe_pie, enumerate_pie_terms, primary_atom_sets
from .frag.mbe import compute_mbe
from .frag.screening import (
    apply_distance_screening,
    distances_for_polymers,
    sort_fragments_by_size,
)
from .geometry import (
    SystemGeometry,
    build_fragment_from_atom_list,
    build_fragment_from_indices,
)
from .io.adapter import (
    CalcType,
    DriverConfig,
    MethodType,
    config_to_driver,
    config_to_system_geometries,
)
from .io.config import MqcConfig, read_mqc_file
from .io.json_writer import (
    build_output_object,
    merge_multi_molecule_json,
    output_filename_for,
    write_json_output,
)
from .numerics.finite_differences import (
    dipole_derivatives_from_dipoles,
    displaced_geometries,
    hessian_from_gradients,
)
from .numerics.thermochemistry import compute_thermochemistry
from .numerics.vibrational import compute_vibrational_analysis
from .results import MbeResult


def make_executor(drv: DriverConfig, devices=None):
    """FragmentExecutor for a driver config: calculator, mesh (over
    `devices`, default all), polish and rescue wired as a run of `drv`
    needs them."""
    import jax.numpy as jnp

    from .methods.factory import create_calculator
    from .parallel.executor import FragmentExecutor
    from .parallel.mesh import fragment_mesh

    calc = create_calculator(drv)
    mesh = fragment_mesh(
        devices,
        global_groups=drv.global_groups,
        nodes_per_group=drv.nodes_per_group,
    )
    polisher = None
    if (
        getattr(calc, "dtype", None) == jnp.float32
        and getattr(drv, "host_polish", "auto") != "off"
    ):
        from .logging_ import global_logger as logger
        from .methods.xtb.polish import HostPolisher, host_polish_available

        if host_polish_available():
            cand = HostPolisher(calc)
            if cand.supports():
                polisher = cand
                logger.info(
                    " mixed precision: f32 device SCC + f64 host polish "
                    "(results match the f64 parity path; host_polish=off "
                    "disables)"
                )
            else:
                logger.info(
                    " host polish unavailable for this method variant; "
                    "results are raw f32"
                )
        else:
            logger.info(
                " no host CPU backend for the f64 polish; results are "
                "raw f32"
            )
    # rescue gate == the driver's own convergence gate
    # (_check_scf_convergence): the executor counts the fragments whose
    # device SCC misses it and, with a polisher, re-solves them in f64 on
    # the host before they would hard-error the run.
    return FragmentExecutor(
        calc, mesh=mesh, polisher=polisher,
        rescue_tol=max(10.0 * drv.method.scf.tolerance, 1e-8),
    )


@dataclass
class MoleculeOutput:
    result: MbeResult
    polymers: Optional[np.ndarray] = None
    max_level: int = 0
    pie_atom_sets: Optional[list] = None
    vibrational: object = None
    thermo: object = None


class _DisplacedFragment:
    """A fragment evaluated at displaced coordinates (same electronics)."""

    __slots__ = ("numbers", "coords", "charge", "multiplicity")

    def __init__(self, base, coords):
        self.numbers = base.numbers
        self.coords = coords
        self.charge = base.charge
        self.multiplicity = base.multiplicity


def _check_scf_convergence(aux, drv: DriverConfig, what: str):
    """Fail loudly when any fragment's SCC stalled.

    The reference aborts when tblite reports a failed singlepoint; a silent
    stall here would return plausible-looking but wrong numbers (the
    stall mode of reduced-precision matmuls), so this is a hard error."""
    resid = np.asarray(aux.get("scf_residual", 0.0))
    tol = max(10.0 * drv.method.scf.tolerance, 1e-8)
    worst = float(resid.max()) if resid.size else 0.0
    if worst > tol:
        bad = int(np.argmax(resid))
        raise ConvergenceError(
            f"SCC did not converge during {what}: fragment {bad} residual "
            f"{worst:.3e} > {tol:.1e} (scf tolerance "
            f"{drv.method.scf.tolerance:.1e}, maxiter "
            f"{drv.method.scf.maxiter}); increase %scf maxiter"
        )


def _fragment_hessians(executor, fragments, displacement, drv=None):
    """Batched FD Hessians (+ dipole derivatives) for a list of fragments.

    All displaced geometries across ALL fragments go into one executor run —
    the batch axis absorbs both the fragment and the displacement sweep.
    """
    jobs, spans = [], []
    for frag in fragments:
        disp = displaced_geometries(np.asarray(frag.coords), displacement)
        start = len(jobs)
        jobs.extend(_DisplacedFragment(frag, c) for c in disp)
        spans.append((start, len(jobs)))

    _, grads, aux = executor.run(jobs, what="gradient")
    if drv is not None:
        _check_scf_convergence(aux, drv, "FD Hessian displacement sweep")
    dipoles = aux["dipole"]

    hessians, dipders = [], []
    for (start, end), frag in zip(spans, fragments):
        g = np.stack([np.asarray(x) for x in grads[start:end]])
        hessians.append(hessian_from_gradients(g, displacement))
        dipders.append(
            dipole_derivatives_from_dipoles(dipoles[start:end], displacement)
        )
    return hessians, dipders


@dataclass
class _ExpansionPlan:
    """Host-side fragment plan for one molecule (build phase of the
    expansion, separated so multi-molecule runs can batch every molecule's
    fragments through ONE executor pass — the batched analog of the
    reference's molecule round-robin, mqc_driver.f90:579-633)."""

    mode: str
    fragments: list
    polymers: Optional[np.ndarray] = None
    atom_sets: Optional[list] = None
    coeffs: Optional[np.ndarray] = None
    distances: Optional[np.ndarray] = None


def _build_plan(sys_geom: SystemGeometry, drv: DriverConfig) -> _ExpansionPlan:
    if drv.nlevel == 0:
        polymers = enumerate_polymers(1, 1)
        sys1 = sys_geom.as_single_monomer() if sys_geom.n_monomers != 1 else sys_geom
        fragments = [build_fragment_from_indices(sys1, [0])]
        return _ExpansionPlan("unfragmented", fragments, polymers=polymers)
    elif drv.use_gmbe:
        level = max(drv.nlevel, 1)
        primaries_tbl = enumerate_polymers(sys_geom.n_monomers, level)
        # GMBE(N) primaries are the N-mers only (monomers are covered by
        # the PIE over primaries); GMBE(1) primaries are the monomers.
        levels = (primaries_tbl >= 0).sum(axis=1)
        primaries_tbl = primaries_tbl[levels == level]
        primaries_tbl = apply_distance_screening(primaries_tbl, sys_geom, drv.cutoffs)
        prim_sets = primary_atom_sets(sys_geom, primaries_tbl)
        atom_sets, coeffs = enumerate_pie_terms(
            prim_sets, drv.max_intersection_level
        )
        fragments = [
            build_fragment_from_atom_list(sys_geom, s) for s in atom_sets
        ]
        return _ExpansionPlan(
            "gmbe", fragments, atom_sets=atom_sets, coeffs=coeffs
        )
    else:
        polymers = enumerate_polymers(sys_geom.n_monomers, drv.nlevel)
        polymers = apply_distance_screening(polymers, sys_geom, drv.cutoffs)
        polymers = sort_fragments_by_size(polymers)
        distances = distances_for_polymers(polymers, sys_geom)
        fragments = [
            build_fragment_from_indices(sys_geom, row[row >= 0]) for row in polymers
        ]
        return _ExpansionPlan(
            "mbe", fragments, polymers=polymers, distances=distances
        )


def _assemble_expansion(
    plan: _ExpansionPlan,
    sys_geom: SystemGeometry,
    drv: DriverConfig,
    energies,
    gradients,
    hessians,
    dipoles,
    dipders,
) -> MoleculeOutput:
    """Assembly + spectroscopy phase (after fragment energies are in)."""
    want_hess = drv.calc_type == CalcType.HESSIAN
    mode, fragments = plan.mode, plan.fragments

    if mode == "gmbe":
        result = compute_gmbe_pie(
            sys_geom,
            fragments,
            plan.coeffs,
            energies,
            gradients=gradients,
            hessians=hessians,
            dipoles=dipoles,
            dipole_derivatives=dipders,
        )
        out = MoleculeOutput(result=result, pie_atom_sets=plan.atom_sets)
    else:
        result = compute_mbe(
            plan.polymers,
            sys_geom,
            fragments,
            energies,
            gradients=gradients,
            hessians=hessians,
            dipoles=dipoles,
            dipole_derivatives=dipders,
            distances=plan.distances,
            max_level=max(drv.nlevel, 1),
        )
        out = MoleculeOutput(
            result=result,
            polymers=plan.polymers if mode == "mbe" else None,
            max_level=drv.nlevel if mode == "mbe" else 0,
        )

    # verbose observability: per-fragment XYZ + per-level deltaE breakdown
    # (mqc_mbe_io.f90:48-155; gated on verbose like the reference)
    if drv.method.verbose:
        from .frag.mbe_io import print_detailed_breakdown, print_fragment_xyz

        for i, frag in enumerate(fragments, start=1):
            print_fragment_xyz(i, frag)
        if (
            mode == "mbe"
            and result.fragment_energies is not None
            and result.delta_energies is not None
        ):
            print_detailed_breakdown(
                plan.polymers,
                result.fragment_energies,
                result.delta_energies,
                max(drv.nlevel, 1),
            )

    # --- vibrational + thermochemistry when a Hessian was produced
    if want_hess and result.hessian is not None:
        vib = compute_vibrational_analysis(
            result.hessian,
            sys_geom.numbers,
            sys_geom.coords,
            dipole_derivatives=result.dipole_derivatives,
        )
        thermo = compute_thermochemistry(
            vib.frequencies,
            sys_geom.numbers,
            sys_geom.coords,
            temperature=drv.hessian.temperature,
            pressure_atm=drv.hessian.pressure,
            spin_multiplicity=sys_geom.multiplicity,
        )
        out.vibrational = vib
        out.thermo = thermo

    return out


def _run_expansion(sys_geom: SystemGeometry, drv: DriverConfig, executor):
    """Single-molecule compute path: build plan, execute, assemble."""
    outputs = _run_expansions([("", sys_geom)], drv, executor)
    return outputs[""]


def _run_expansions(systems, drv: DriverConfig, executor) -> dict:
    """Run one or more molecules through ONE batched executor pass.

    The reference round-robins independent molecules over MPI ranks
    (mqc_driver.f90:579-633); here every molecule's fragments join the same
    device-sharded batch, so multi-molecule inputs keep the mesh full.
    """
    want_grad = drv.calc_type in (CalcType.GRADIENT, CalcType.HESSIAN)
    want_hess = drv.calc_type == CalcType.HESSIAN

    plans, spans = [], []
    all_frags = []
    for name, sys_geom in systems:
        try:
            plan = _build_plan(sys_geom, drv)
        except Exception as exc:
            raise with_context(exc, f"molecule {name or '(single)'}")
        start = len(all_frags)
        all_frags.extend(plan.fragments)
        plans.append((name, sys_geom, plan))
        spans.append((start, len(all_frags)))

    if want_grad:
        energies, gradients, aux = executor.run(all_frags, what="gradient")
    else:
        energies, aux = executor.run(all_frags, what="energy")
        gradients = None
    _check_scf_convergence(aux, drv, "fragment evaluation")
    dipoles = aux["dipole"]

    hessians = dipders = None
    if want_hess:
        hessians, dipders = _fragment_hessians(
            executor, all_frags, drv.hessian.displacement, drv=drv
        )

    outputs = {}
    for (name, sys_geom, plan), (a, b) in zip(plans, spans):
        try:
            outputs[name] = _assemble_expansion(
                plan,
                sys_geom,
                drv,
                energies[a:b],
                gradients[a:b] if gradients is not None else None,
                hessians[a:b] if hessians is not None else None,
                dipoles[a:b],
                dipders[a:b] if dipders is not None else None,
            )
        except Exception as exc:
            raise with_context(exc, f"molecule {name or '(single)'}")
    return outputs


def run_calculation(
    cfg: MqcConfig,
    input_path: str = "input.mqc",
    write_json: bool = True,
    executor=None,
    driver_overrides: Optional[dict] = None,
):
    """Run a parsed configuration. Returns {molecule_name or '': MoleculeOutput}.

    driver_overrides sets DriverConfig attributes not expressible in the
    .mqc format (CLI precision/polish flags). Writes output_<base>.json
    (reference schema) unless disabled.
    """
    drv = config_to_driver(cfg)
    for key, val in (driver_overrides or {}).items():
        setattr(drv, key, val)
    executor = executor or make_executor(drv)
    systems = config_to_system_geometries(cfg)

    outputs = _run_expansions(systems, drv, executor)

    if write_json and not drv.skip_json_output:
        base = os.path.splitext(os.path.basename(input_path))[0]
        path = output_filename_for(input_path)
        if len(outputs) == 1 and "" in outputs:
            out = outputs[""]
            write_json_output(
                path,
                base,
                out.result,
                polymers=out.polymers,
                max_level=out.max_level,
                pie_atom_sets=out.pie_atom_sets,
                vibrational=out.vibrational,
                thermo=out.thermo,
            )
        else:
            mol_objects = {
                name: build_output_object(
                    out.result,
                    polymers=out.polymers,
                    max_level=out.max_level,
                    pie_atom_sets=out.pie_atom_sets,
                    vibrational=out.vibrational,
                    thermo=out.thermo,
                )
                for name, out in outputs.items()
            }
            merge_multi_molecule_json(path, base, mol_objects)
    return outputs


def run_file(path: str, write_json: bool = True, driver_overrides=None,
             executor=None):
    cfg = read_mqc_file(path)
    return run_calculation(
        cfg, input_path=path, write_json=write_json, executor=executor,
        driver_overrides=driver_overrides,
    )


# ---------------------------------------------------------------------------
# External calculation interface (optimizers / AIMD / MC)
# ---------------------------------------------------------------------------


def compute_energy_and_forces(
    sys_geom: SystemGeometry,
    drv: DriverConfig,
    executor=None,
    want_gradient: bool = True,
    want_hessian: bool = False,
):
    """Re-entrant single-geometry evaluation for dynamics drivers.

    Parity with /root/reference/src/interface/mqc_calculation_interface.f90.
    Returns (energy, gradient or None, hessian or None).
    """
    import copy

    drv2 = copy.copy(drv)
    drv2.calc_type = (
        CalcType.HESSIAN
        if want_hessian
        else (CalcType.GRADIENT if want_gradient else CalcType.ENERGY)
    )
    executor = executor or make_executor(drv2)
    out = _run_expansion(sys_geom, drv2, executor)
    return out.result.total_energy, out.result.gradient, out.result.hessian
