"""Typed exception hierarchy of the public parse API.

Every error the parse runtime raises on purpose derives from ``ParseError``,
so ``except repro.ParseError`` is the one catch-all a caller needs.  The
subclasses double-inherit from the builtin exceptions the pre-facade services
used to raise bare (``KeyError`` for unknown sessions, ``ValueError`` for
malformed/over-budget requests), so existing ``except KeyError`` /
``except ValueError`` call sites keep working one release longer.

This module is dependency-free on purpose: ``import repro`` exposes it
without paying the jax import cost (see ``repro/__init__``'s lazy exports).
"""

from __future__ import annotations

from typing import Optional, Tuple


class ParseError(Exception):
    """Base class of every typed error the parse runtime raises."""


class AdmissionError(ParseError):
    """Deadline-aware admission rejected a request.

    Raised at submit/append time — before any device work — when the
    request's shape bucket has an observed p99 latency that already exceeds
    the remaining deadline (or the deadline is already blown).  Carries the
    numbers the scheduler used, so callers can retry with a looser deadline
    or route the request elsewhere.
    """

    def __init__(
        self,
        message: str,
        *,
        bucket=None,
        deadline_s: Optional[float] = None,
        predicted_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.bucket = bucket
        self.deadline_s = deadline_s
        self.predicted_s = predicted_s


class SessionNotFound(ParseError, KeyError):
    """A stream operation named a session id that is not open.

    Subclasses ``KeyError`` because ``StreamService`` used to raise the bare
    builtin — old ``except KeyError`` handlers still catch it.
    """

    def __init__(self, sid):
        super().__init__(f"no open stream session with id {sid!r}")
        self.sid = sid

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0]


class PathologicalPatternError(ParseError, ValueError):
    """The static analyzer rejected a pattern as pathologically ambiguous.

    Raised under ``analyze="strict"`` — at ``Parser`` construction, at
    ``ParserFleet.add``, and by the services' admission guards — when
    ``repro.analyze`` diagnoses infinite ambiguity (an iterator with a
    nullable body, e.g. ``(a*)*``): a single text then has unboundedly many
    parse trees, so forest size is not bounded by input length and no
    speculation-width bound holds.  Carries the pattern and the analyzer's
    verdict so multi-tenant callers can report which tenant was refused.

    Subclasses ``ValueError`` like the other malformed-request rejections,
    so blanket ``except ValueError`` admission handlers keep catching it.
    """

    def __init__(self, message: str, *, pattern: Optional[str] = None,
                 ambiguity: Optional[str] = None):
        super().__init__(message)
        self.pattern = pattern
        self.ambiguity = ambiguity


class BudgetExceeded(ParseError, ValueError):
    """A request was rejected because it would exceed a configured budget
    (queue depth, pending characters, seal-boundary piece size, …).

    Subclasses ``ValueError`` because the pre-facade paths raised the bare
    builtin for over-budget work — old handlers keep catching it.
    """

    def __init__(self, message: str, *, budget=None, requested=None):
        super().__init__(message)
        self.budget = budget
        self.requested = requested
