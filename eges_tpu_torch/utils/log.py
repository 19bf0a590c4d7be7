"""Structured logging with the Geec extensions.

The port's copy of ``eges_tpu/utils/log.py``, unchanged but for its imports.

The reference adds two log levels to log15 — ``LvlGeec`` and ``Gdbug``
(ref: log/logger.go:23,85-88, log/root.go:63-68) — and emits its
``--breakdown`` phase timings as log lines harvested by ``grep.py``
(SURVEY §5: "observability is logging-first").  Same model here: stdlib
logging with two custom levels between the standard ones, key=value
formatting, and a helper the harness's grep-style assertions parse.
"""

from __future__ import annotations

import logging
import sys

# Between WARNING(30) and INFO(20), like the reference's ordering
GEEC = 25
GDBUG = 15

logging.addLevelName(GEEC, "GEEC")
logging.addLevelName(GDBUG, "GDBUG")


def _fmt_kv(kwargs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in kwargs.items())


class GeecLogger(logging.LoggerAdapter):
    """``log.geec("Elected", blk=5, version=0)`` -> ``GEEC Elected blk=5 ...``"""

    def geec(self, msg: str, **kw) -> None:
        self.logger.log(GEEC, "%s %s", msg, _fmt_kv(kw))

    def gdbug(self, msg: str, **kw) -> None:
        self.logger.log(GDBUG, "%s %s", msg, _fmt_kv(kw))

    def info(self, msg: str, **kw) -> None:  # type: ignore[override]
        self.logger.info("%s %s", msg, _fmt_kv(kw))

    def warn(self, msg: str, **kw) -> None:
        self.logger.warning("%s %s", msg, _fmt_kv(kw))

    def breakdown(self, phase: str, dt: float, **kw) -> None:
        """Phase timing lines (ref: '[Breakdown 1] Election time',
        consensus/geec/geec.go:313-317).  Logged at GEEC level: these
        lines exist to be harvested from logs (grep.py workflow), so the
        default verbosity must not filter them."""
        self.logger.log(GEEC, "[Breakdown] %s time=%.6fs %s", phase, dt,
                        _fmt_kv(kw))


def get_logger(name: str, verbosity: int = 3,
               stream=None) -> GeecLogger:
    """Verbosity mapping follows geth --verbosity: 1=error..5=trace.

    Idempotent: repeated calls re-level the existing handler instead of
    keeping the first level forever, and a different ``stream`` retargets
    that handler rather than stacking a second one (which used to
    double every log line).
    """
    level = {1: logging.ERROR, 2: logging.WARNING, 3: GEEC,
             4: logging.DEBUG, 5: 1}.get(verbosity, GEEC)
    logger = logging.getLogger(name)
    logger.setLevel(level)
    ours = [h for h in logger.handlers if getattr(h, "_geec", False)]
    if not ours:
        h = logging.StreamHandler(stream or sys.stdout)
        h._geec = True
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        ours = [h]
    for h in ours:
        h.setLevel(level)
        if stream is not None and h.stream is not stream:
            h.setStream(stream)
    return GeecLogger(logger, {})
