"""Line searches: the configs of the Armijo family that the whole-solve
kernel K3 runs (:class:`BackTracking`, :class:`BackTrackingB`,
:class:`GLLQuadratic`, :class:`NoSearch`), and the MINPACK-2 ``dcstep``
trial update that the tall kernel's in-kernel dcsrch uses
(:mod:`.dcsrch`)."""

from .backtracking import BackTracking, BackTrackingB
from .base import Bounds, LineSearch
from .gll import GLLQuadratic
from .nosearch import NoSearch

__all__ = ["Bounds", "LineSearch", "BackTracking", "BackTrackingB",
           "GLLQuadratic", "NoSearch"]
