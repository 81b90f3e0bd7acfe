"""L-BFGS-B configuration.

Counterpart of ``LbfgsbConfig`` in
``optimization_solvers_tpu/solvers/lbfgsb.py`` with the same fields and
defaults, so a config crosses between the two packages through
``dataclasses.asdict``.  The lockstep dcsrch solver that honours ``ls_c2``,
``rel_pg_stop``, ``verbose`` and ``curvature_eps`` is not ported yet
(ROADMAP.md Queue 1 item 3); the fused routes honour ``m``, ``pgtol``,
``factr``, ``max_iter``, ``max_iter_ls`` and ``ls_c1``, and the tall kernel
also ``tall_line_search`` (``"armijo"`` or ``"dcsrch"``; any other value
raises ``ValueError``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LbfgsbConfig:
    """``factr`` is multiplied by machine epsilon (Fortran convention);
    ``m`` defaults to 5, recommended range [3, 20]."""

    m: int = 5
    factr: float = 1e7
    pgtol: float = 1e-5
    rel_pg_stop: bool = False   # reference wrapper rule: pg_inf <= 1e-10 * f
    max_iter: int = 500
    max_iter_ls: int = 20
    ls_c1: float = 1e-3         # Armijo / dcsrch ftol
    ls_c2: float = 0.9          # dcsrch gtol
    curvature_eps: float = 2.2e-16
    verbose: int = -1
    gcp_chunk: int = 256        # lockstep GCP walk chunk
    lockstep_unroll: int = 1    # lockstep iterations per loop trip
    tall_line_search: str = "armijo"   # line search of the tall kernel

    def __post_init__(self):
        if self.tall_line_search not in ("armijo", "dcsrch"):
            raise ValueError(
                "tall_line_search must be 'armijo' or 'dcsrch', got "
                f"{self.tall_line_search!r}")
