"""Strong Dirichlet boundary conditions on the monolithic U vector.

A BC pins a set of global U indices to (possibly time-dependent) values.
Values are imposed strongly before each Newton solve; constrained rows act
as identity in the Jacobian (reference semantics: DirichletBC applied to the
mixed system each iteration, e.g.
reference: src/vasp/simulations/cylinder.py:182-191)."""
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch


@dataclass
class DirichletBC:
    dofs: np.ndarray  # global U indices
    value: Union[np.ndarray, float, Callable] = 0.0  # array, scalar, or fn(t)->array

    def values_at(self, t: float) -> np.ndarray:
        if callable(self.value):
            v = np.asarray(self.value(t), dtype=np.float64)
            if v.ndim == 0:
                v = np.full(len(self.dofs), float(v))
            return v
        v = np.asarray(self.value, dtype=np.float64)
        if v.ndim == 0:
            return np.full(len(self.dofs), float(v))
        return v


class BCSet:
    """Collection of DirichletBCs with a combined mask and value evaluation.

    Later BCs in the list win on overlapping dofs (matching dolfin's
    apply-in-order semantics)."""

    def __init__(self, ndof: int, bcs: Sequence[DirichletBC]):
        self.ndof = ndof
        self.bcs = list(bcs)
        mask = np.zeros(ndof, dtype=bool)
        for bc in self.bcs:
            mask[bc.dofs] = True
        self.mask = mask
        self._mask_dev: Optional[torch.Tensor] = None
        self._static_values: Optional[np.ndarray] = None
        if all(not callable(bc.value) for bc in self.bcs):
            self._static_values = self.values_at(0.0)

    def values_at(self, t: float) -> np.ndarray:
        if self._static_values is not None:
            return self._static_values
        vals = np.zeros(self.ndof)
        for bc in self.bcs:
            vals[bc.dofs] = bc.values_at(t)
        return vals

    def mask_on(self, device) -> torch.Tensor:
        """The bool (ndof,) mask as a tensor on `device` (cached)."""
        device = torch.device(device)
        if self._mask_dev is None or self._mask_dev.device != device:
            self._mask_dev = torch.as_tensor(self.mask, device=device)
        return self._mask_dev

    def apply(self, U: torch.Tensor, t: float) -> torch.Tensor:
        """Return U (a float64 tensor) with constrained entries set to g(t),
        on U's device."""
        vals = torch.as_tensor(self.values_at(t), dtype=U.dtype,
                               device=U.device)
        return torch.where(self.mask_on(U.device), vals, U)
