"""Bucketed, sharded fragment execution.

Fragments are grouped into size buckets (static shapes -> stable jit cache),
each bucket is padded to a multiple of the device count, built into one
FragmentData batch, sharded over the mesh, and evaluated in a single
jit/vmap call. This replaces the reference's dynamic MPI work queues
(SURVEY §2.6): static sharding of padded batches instead of request/reply
scheduling.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..methods.xtb.batch import element_basis
from ..methods.xtb.calculator import XtbCalculator
from .mesh import fragment_mesh, shard_leading_axis

#: atom-count bucket ladder; shells/AOs scale with atoms per bucket
ATOM_BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

_DUMMY = (np.array([1]), np.zeros((1, 3)), 0, 2)  # lone H (doublet) filler


def _bucket_of(n_atoms: int) -> int:
    for b in ATOM_BUCKETS:
        if n_atoms <= b:
            return b
    return int(np.ceil(n_atoms / 64.0) * 64)


def _frag_tuple(frag, variant):
    if hasattr(frag, "numbers"):
        return (
            np.asarray(frag.numbers),
            np.asarray(frag.coords),
            getattr(frag, "charge", 0),
            getattr(frag, "multiplicity", 1),
        )
    return frag


def _sizes(numbers, variant):
    nsh = nao = 0
    for z in numbers:
        eb = element_basis(int(z), variant)
        nsh += eb.n_shells
        nao += eb.n_ao
    return nsh, nao


class FragmentExecutor:
    """Evaluates lists of fragments on the device mesh.

    what='energy'  -> (energies, aux)
    what='gradient'-> (energies, gradients, aux); gradients are returned
                      per-fragment, truncated to each fragment's real size.
    """

    def __init__(self, calculator: XtbCalculator = None, mesh=None,
                 polisher=None, rescue_tol=None):
        self.calc = calculator or XtbCalculator()
        self.mesh = mesh if mesh is not None else fragment_mesh()
        self.n_devices = int(np.prod([d for d in self.mesh.devices.shape]))
        #: optional HostPolisher (methods/xtb/polish.py): when set, every
        #: chunk's f32 device results are re-evaluated in f64 on the host
        #: CPU from the device-converged charges, so assembled energies,
        #: gradients and FD Hessians match the f64 parity path.
        self.polisher = polisher
        #: residual threshold above which a fragment's device SCC is
        #: considered failed: counted in n_device_unconverged and, with a
        #: polisher, re-solved from scratch in f64 on the host
        #: (polisher.rescue). None disables both; the driver sets it to its
        #: own convergence gate so no fragment the rescue could save errors
        #: out.
        self.rescue_tol = rescue_tol
        #: fragments evaluated, whose device SCC residual (read before the
        #: polish replaces it) missed rescue_tol, and re-solved by the host
        #: rescue, over this executor's lifetime. The polish's f64 SCC
        #: starts from the device charges and can converge a fragment the
        #: device did not, so only the device count shows a device that
        #: fails; the rescue count shows what the polish could not save.
        self.n_evaluated = 0
        self.n_device_unconverged = 0
        self.n_rescued = 0

    def _buckets(self, fragments):
        groups = defaultdict(list)
        for i, frag in enumerate(fragments):
            numbers, coords, charge, mult = _frag_tuple(frag, self.calc.variant)
            groups[_bucket_of(len(numbers))].append(
                (i, (numbers, coords, charge, mult))
            )
        return groups

    def _pad_shapes_for(self, bucket_atoms, members):
        """Static (nat, nsh, nao) for a bucket: scale worst-case per atom."""
        max_nsh = max_nao = 0
        for _, (numbers, *_rest) in members:
            nsh, nao = _sizes(numbers, self.calc.variant)
            max_nsh, max_nao = max(max_nsh, nsh), max(max_nao, nao)
        # round shells/AOs up to the bucket's worst case with 2/atom slack
        nsh = max(max_nsh, 2 * bucket_atoms)
        nao = max(max_nao, int(2.5 * bucket_atoms) + 1)
        return bucket_atoms, nsh, nao

    def run(self, fragments, what: str = "energy"):
        import time

        from ..logging_ import global_logger as logger

        n = len(fragments)
        t0 = time.time()
        n_done = 0
        energies = np.zeros(n)
        gradients = [None] * n if what == "gradient" else None
        aux_out = {
            "charges": [None] * n,
            "dipole": np.zeros((n, 3)),
            "scf_residual": np.zeros(n),
        }

        for bucket_atoms, members in sorted(self._buckets(fragments).items()):
            pad_to = self._pad_shapes_for(bucket_atoms, members)
            # memory guard: cap B * nao^2 per dispatched batch (the engine
            # holds several (B, nao, nao) intermediates) so e.g. a
            # large-molecule FD-Hessian sweep (6N displacements of an
            # N-atom system in one bucket) streams in chunks instead of
            # materializing tens of GB. The 2e8 cap is carried over, not
            # yet sized from the GPU's measured peak memory.
            nao_pad = pad_to[2]
            max_b = max(self.n_devices,
                        int(2.0e8 // max(1, nao_pad * nao_pad)))
            max_b -= max_b % self.n_devices or 0
            max_b = max(self.n_devices, max_b)
            for start in range(0, len(members), max_b):
                chunk = members[start : start + max_b]
                self._run_chunk(chunk, pad_to, what, energies, gradients,
                                aux_out)
                n_done += len(chunk)
                if n > 1:
                    logger.info(
                        f"  Processed {n_done}/{n} fragments "
                        f"[{time.time() - t0:.2f} s]"
                    )

        if what == "gradient":
            return energies, gradients, aux_out
        return energies, aux_out

    def _run_chunk(self, members, pad_to, what, energies, gradients, aux_out):
        idxs = [i for i, _ in members]
        tuples = [t for _, t in members]
        # pad the batch to a device-count multiple with dummy fragments
        tuples = tuples + [_DUMMY] * ((-len(tuples)) % self.n_devices)
        self.n_evaluated += len(idxs)

        frag_data = self.calc.make_batch(tuples, pad_to=pad_to)
        frag_data = shard_leading_axis(frag_data, self.mesh)

        if what == "gradient":
            e, g, aux = self.calc.gradients(frag_data)
            g = np.asarray(g)
        else:
            e, aux = self.calc.energies(frag_data)
            g = None
        if self.rescue_tol is not None:
            res_dev = np.asarray(aux["scf_residual"])[: len(idxs)]
            self.n_device_unconverged += int(
                np.count_nonzero(res_dev > self.rescue_tol)
            )
        if self.polisher is not None:
            e, g_p, aux = self.polisher.polish(
                tuples, pad_to, aux["shell_charges"], what
            )
            if what == "gradient":
                g = np.asarray(g_p)
        e = np.asarray(e)
        dip = np.asarray(aux["dipole"])
        chg = np.asarray(aux["charges"])
        res = np.asarray(aux["scf_residual"])

        # f64 host rescue: fragments whose f32 device SCC failed to reach
        # the driver's convergence gate (slow-contracting GMBE coincident-
        # cap terms, charged clusters) are re-solved from scratch in f64 on
        # the host instead of hard-erroring the whole run. The CPU parity
        # path (f64 device SCC) never triggers this.
        if self.polisher is not None and self.rescue_tol is not None:
            bad = [s for s in range(len(idxs)) if res[s] > self.rescue_tol]
            if bad:
                from ..logging_ import global_logger as logger

                self.n_rescued += len(bad)
                logger.info(
                    f"  f64 host rescue: {len(bad)} fragment(s) with f32 "
                    f"SCC residual > {self.rescue_tol:.1e}"
                )
                e_r, g_r, aux_r = self.polisher.rescue(
                    [tuples[s] for s in bad], pad_to, what
                )
                e, dip, chg, res = (
                    np.array(e), np.array(dip), np.array(chg), np.array(res)
                )
                if g is not None:
                    g = np.array(g)
                for j, s in enumerate(bad):
                    e[s] = e_r[j]
                    dip[s] = aux_r["dipole"][j]
                    chg[s] = aux_r["charges"][j]
                    res[s] = aux_r["scf_residual"][j]
                    if g is not None:
                        g[s] = g_r[j]

        for slot, i in enumerate(idxs):
            n_at = len(tuples[slot][0])
            energies[i] = e[slot]
            aux_out["dipole"][i] = dip[slot]
            aux_out["charges"][i] = chg[slot][:n_at]
            aux_out["scf_residual"][i] = res[slot]
            if g is not None:
                gradients[i] = g[slot][:n_at]
