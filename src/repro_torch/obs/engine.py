"""The serving engine's spans: what ``runtime.scheduler.ContinuousBatcher``
records when it is given an :class:`EngineTrace`.

A span is a name, a start and an end in ns, the id of the span that was
open around it when it began (its parent; None at the top), the request it
serves (None for the engine's own work) and a few integer attributes.  The
record keeps finished spans in memory, in the order they ended, and
:meth:`EngineTrace.take` hands them over and clears it, so that a caller
that runs for long drains it as it goes; a span still open stays for the
next ``take``.

Times are ``time.time_ns()``, the clock of ``torch.profiler``'s events, so
a span lies on the profiler's device timeline without the profiler
recording it.  The spans are plain Python objects and not
``record_function`` ranges: the profiler would mirror such a range onto the
device's timeline, where it reads as device work.

Pure Python: this module imports no torch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass(slots=True)
class Span:
    id: int
    name: str
    start: int  # ns, time.time_ns()
    end: int = 0  # ns; 0 while the span is open
    parent: Optional[int] = None  # the id of the span open around it
    rid: Optional[int] = None  # the request it serves
    attrs: dict = field(default_factory=dict)


class EngineTrace:
    """Spans nested by the order they open and close in: :meth:`begin`
    opens a span inside the innermost open one, :meth:`end` closes it,
    :meth:`lap` records a finished child of the innermost open span, and
    :meth:`add` a finished span at the top."""

    def __init__(self):
        self._done: list[Span] = []
        self._open: list[Span] = []
        self._ids = 0

    @staticmethod
    def now() -> int:
        return time.time_ns()

    def _new(self, name: str, start: int, end: int, parent: Optional[int],
             rid: Optional[int], attrs: dict) -> Span:
        s = Span(self._ids, name, start, end, parent, rid, attrs)
        self._ids += 1
        return s

    def _parent(self) -> Optional[int]:
        return self._open[-1].id if self._open else None

    def begin(self, name: str, rid: Optional[int] = None, **attrs: int) -> Span:
        s = self._new(name, time.time_ns(), 0, self._parent(), rid, attrs)
        self._open.append(s)
        return s

    def end(self, span: Span, **attrs: int) -> int:
        """Close ``span`` (with ``attrs`` added) and return its end.  Spans
        opened inside it and left open, by a raise, are dropped."""
        while self._open.pop() is not span:
            pass
        span.end = time.time_ns()
        span.attrs.update(attrs)
        self._done.append(span)
        return span.end

    def lap(self, name: str, start: int) -> int:
        """Record ``name`` from ``start`` to now inside the innermost open
        span and return now, the start of the next lap."""
        now = time.time_ns()
        self._done.append(self._new(name, start, now, self._parent(), None, {}))
        return now

    def add(self, name: str, start: int, end: int, rid: Optional[int] = None,
            **attrs: int) -> None:
        """Record a finished span at the top, from ``start`` to ``end``."""
        self._done.append(self._new(name, start, end, None, rid, attrs))

    def take(self) -> list[Span]:
        """The finished spans since the last ``take``, and clear them."""
        done, self._done = self._done, []
        return done
