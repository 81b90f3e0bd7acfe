"""Line searches.  So far the MINPACK-2 ``dcstep`` trial update that the
tall kernel's in-kernel dcsrch uses (:mod:`.dcsrch`)."""
