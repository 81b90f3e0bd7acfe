"""Line searches, each a config that the whole-solve kernel K3 reads and a
lockstep body that the lockstep driver runs -- the Armijo family
(:class:`BackTracking`, :class:`BackTrackingB`, :class:`GLLQuadratic`,
:class:`NoSearch`) and the Wolfe family (:class:`MoreThuente`,
:class:`MoreThuenteB`, :class:`HagerZhang`, :class:`HagerZhangB`,
:class:`StrongWolfe`) -- the shared Wolfe-condition predicates, and the
MINPACK-2 ``dcstep`` update (:mod:`.dcsrch`)."""

from .backtracking import BackTracking, BackTrackingB
from .base import (Bounds, LineSearch, curvature_condition,
                   strong_curvature_condition, strong_wolfe,
                   sufficient_decrease)
from .dcsrch import StrongWolfe
from .gll import GLLQuadratic
from .hager_zhang import HagerZhang, HagerZhangB
from .morethuente import MoreThuente, MoreThuenteB
from .nosearch import NoSearch

__all__ = ["Bounds", "LineSearch", "BackTracking", "BackTrackingB",
           "MoreThuente", "MoreThuenteB", "StrongWolfe", "GLLQuadratic",
           "HagerZhang", "HagerZhangB", "NoSearch", "strong_wolfe",
           "sufficient_decrease", "curvature_condition",
           "strong_curvature_condition"]
