"""metalquicha-tpu: fragmented quantum chemistry framework in JAX.

Many-Body Expansion (MBE) and Generalized MBE (GMBE/PIE) energies, analytic
gradients (via JAX autodiff), finite-difference Hessians, vibrational
frequencies, IR intensities and RRHO thermochemistry over a native batched
GFN1/GFN2-xTB engine, executed as padded fragment batches sharded across a
`jax.sharding.Mesh`.

A re-design with the capabilities of the reference Fortran/MPI
implementation (JorgeG94/metalquicha): the MPI coordinator hierarchy is
replaced by SPMD sharding; tblite is replaced by a JAX xTB engine; analytic
gradient code is replaced by autodiff.
"""

__version__ = "0.1.0"

from . import constants, elements  # noqa: F401
from .errors import ConvergenceError, InputError, MqcError  # noqa: F401
from .geometry import (  # noqa: F401
    Bond,
    PhysicalFragment,
    SystemGeometry,
    build_fragment_from_atom_list,
    build_fragment_from_indices,
)
