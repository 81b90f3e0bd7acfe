"""The package logger and the per-iteration tracer of the lockstep solvers.

PyTorch counterpart of the part of
:mod:`optimization_solvers_tpu.utils.telemetry` that ``LbfgsbConfig.verbose``
needs: :func:`get_logger`, :func:`debug_enabled` (the ``OST_LOG``
environment variable, the analogue of the reference's ``RUST_LOG``) and
:func:`iteration_tracer`.  The port's loops run on the host, so the tracer
is called directly with the batch's tensors where JAX stages a
``jax.debug.callback``; the messages are the JAX package's, under this
package's logger name.
"""

from __future__ import annotations

import logging
import os
import sys

LOGGER_NAME = "optimization_solvers_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(target: str = "") -> logging.Logger:
    name = f"{LOGGER_NAME}.{target}" if target else LOGGER_NAME
    return logging.getLogger(name)


def debug_enabled() -> bool:
    """True when per-iteration solver tracing should be emitted: ``OST_LOG``
    says ``debug`` or ``trace``, or the package logger is configured at
    DEBUG level with a handler.  Read at each solve's set-up."""
    name = os.environ.get("OST_LOG", "").upper()
    if name in ("DEBUG", "TRACE"):
        return True
    logger = logging.getLogger(LOGGER_NAME)
    return logger.getEffectiveLevel() <= logging.DEBUG and bool(
        logger.handlers)


def _ensure_default_handler() -> None:
    """``OST_LOG=debug`` alone must produce visible output: without a
    handler on the package logger, install a stdout one at the level
    ``OST_LOG`` names (``trace`` is ``debug``; default ``info``)."""
    logger = logging.getLogger(LOGGER_NAME)
    if logger.handlers:
        return
    level = os.environ.get("OST_LOG", "info").upper()
    level = {"TRACE": "DEBUG"}.get(level, level)
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)


def iteration_tracer(target: str, level: int = logging.DEBUG):
    """Per-iteration event sink ``cb(k, f, gnorm, t)``: logs ``k / f /
    ||pg|| / t`` under ``target``.  A batch of one logs its values; a larger
    batch logs aggregate statistics (JAX ``telemetry.py:140-178``).  Each
    call reads the tensors to the host."""
    import numpy as np

    _ensure_default_handler()
    logger = get_logger(target)

    def cb(k, f, gnorm, t):
        k_, f_, g_, t_ = (np.asarray(v.detach().cpu())
                          for v in (k, f, gnorm, t))
        if k_.size == 1:
            logger.log(
                level, "k=%-5d f=%.8e ||g||=%.3e t=%.3e",
                int(k_.reshape(())), float(f_.reshape(())),
                float(g_.reshape(())), float(t_.reshape(())))
        else:
            logger.log(
                level, "k<=%-5d batch=%d f_p50=%.8e ||g||_max=%.3e t_p50=%.3e",
                int(k_.max()), k_.size, float(np.median(f_)),
                float(g_.max()), float(np.median(t_)))

    return cb
