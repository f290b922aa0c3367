"""Placeholder HF/DFT/MCSCF methods.

The reference ships non-functional placeholders that return dummy values
(/root/reference/src/methods/mqc_method_hf.f90:47-107 energy = -1.0;
mqc_method_dft.f90:108-143 energy = -1.0 * natoms; mcscf similar). These
exist so the framework/method seam is exercised end-to-end; real HF/DFT on
an accelerator (dense integrals as batched matmuls) is future work.
"""

from __future__ import annotations

import numpy as np

from .base import QCMethod


class _StubBase(QCMethod):
    def make_batch(self, fragments, pad_to=None):
        out = []
        for frag in fragments:
            if hasattr(frag, "numbers"):
                out.append(
                    (np.asarray(frag.numbers), np.asarray(frag.coords))
                )
            else:
                out.append((np.asarray(frag[0]), np.asarray(frag[1])))
        return out

    def _energy_of(self, numbers) -> float:
        raise NotImplementedError

    def energies(self, batch):
        e = np.array([self._energy_of(numbers) for numbers, _ in batch])
        aux = {
            "charges": np.zeros((len(batch), max(len(n) for n, _ in batch))),
            "dipole": np.zeros((len(batch), 3)),
            "scf_residual": np.zeros(len(batch)),
        }
        return e, aux

    def gradients(self, batch):
        e, aux = self.energies(batch)
        g = np.stack(
            [np.zeros((max(len(n) for n, _ in batch), 3)) for n, _ in batch]
        )
        return e, g, aux


class HFMethod(_StubBase):
    variant = "hf"

    def _energy_of(self, numbers) -> float:
        return -1.0


class DFTMethod(_StubBase):
    variant = "dft"

    def _energy_of(self, numbers) -> float:
        return -1.0 * len(numbers)


class MCSCFMethod(_StubBase):
    variant = "mcscf"

    def _energy_of(self, numbers) -> float:
        return -1.0
