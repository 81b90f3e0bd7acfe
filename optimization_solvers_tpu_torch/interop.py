"""Carry configs, data and results between the JAX package and this one.

Both packages are fed through these helpers in the parity tests, so they
see the same numbers: numpy arrays in, numpy arrays out.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import SolveResult
from .solvers.lbfgsb import LbfgsbConfig


def config_from_fields(fields: dict) -> LbfgsbConfig:
    """An :class:`LbfgsbConfig` from ``dataclasses.asdict`` of the JAX
    package's ``LbfgsbConfig``; an unknown field raises ``TypeError``."""
    return LbfgsbConfig(**fields)


def tensors_from_numpy(*arrays, device="cpu", dtype=torch.float64):
    """Torch tensors on ``device`` from numpy arrays (or scalars); floating
    arrays are cast to ``dtype``, others keep their type."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(device=device,
                        dtype=dtype if a.dtype.kind == "f" else t.dtype))
    return tuple(out)


def result_to_numpy(result: SolveResult) -> SolveResult:
    """The same :class:`SolveResult` with every tensor field as a numpy
    array on the host (``None`` fields stay ``None``)."""
    return SolveResult(*(
        None if v is None else v.detach().cpu().numpy() for v in result))
