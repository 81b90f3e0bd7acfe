from .types import FuncEval, SolveResult, Status
from .numerics import box_projection, infinity_norm, projected_gradient
from . import problems

__all__ = ["FuncEval", "SolveResult", "Status", "box_projection",
           "infinity_norm", "projected_gradient", "problems"]
