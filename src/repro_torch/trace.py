"""The port's span recorder: where the host's time goes inside the client,
the service and the broker.

Off by default; :func:`enable` and :func:`disable` switch it.  Off,
:func:`span` returns one shared no-op context (a module-global read and a
call; nothing is allocated or recorded).  On, each span records its name,
its start and end on ``time.perf_counter_ns()`` (the clock the
benchmark's spans use), its own id and its parent's (the innermost span
open on the same thread), a trace id shared by every span of one request,
the thread, whether it is a *wait* (the host blocked on the card, a lock
or a queue) and its attributes.

A trace id is given to a request's root span (``client.submit_many``:
``"<session>/<seq>"`` for an update chunk, ``"<session>/q<n>"`` for a
query request); a span opened inside it takes its parent's, and a span
with neither takes its own id.  A span that starts on one thread and ends
on another (a request's time in the broker's queue) is recorded whole by
:func:`record`.

Spans are kept in memory, at most :data:`CAPACITY`; beyond that they are
counted as dropped.  :func:`take` hands the spans over and clears the
store.  Recording takes no lock: ids come from ``itertools.count`` and the
store is a list appended to, both atomic under the interpreter lock (a
store read while threads record may hold up to one span a thread past
:data:`CAPACITY`).

``docs/TRACING_TORCH.md`` lists the spans and what each brackets.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

CAPACITY = 1 << 20

_on = False
_store: list = []
_dropped = itertools.count()
_ids = itertools.count(1)
_tls = threading.local()
now = time.perf_counter_ns


class Span(NamedTuple):
    """One recorded span; times in ``perf_counter_ns``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0 for a root
    trace_id: object
    thread: int
    wait: bool
    attrs: Optional[dict]


class _Noop:
    """The shared span of a tracer that is off."""
    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value) -> None:
        pass


NOOP = _Noop()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _append(rec: Span) -> None:
    if len(_store) < CAPACITY:
        _store.append(rec)
    else:
        next(_dropped)


class _Live:
    """A span of a tracer that is on; its id is drawn when it is made."""
    __slots__ = ("name", "trace_id", "wait", "attrs", "id", "parent",
                 "t0")

    def __init__(self, name, trace_id, wait):
        self.name, self.trace_id, self.wait = name, trace_id, wait
        self.attrs = None
        self.id = next(_ids)

    def __enter__(self):
        st = _stack()
        if st:
            top = st[-1]
            self.parent = top.id
            if self.trace_id is None:
                self.trace_id = top.trace_id
        else:
            self.parent = 0
            if self.trace_id is None:
                self.trace_id = self.id
        st.append(self)
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _append(Span(self.name, self.t0, t1, self.id, self.parent,
                     self.trace_id, threading.get_ident(), self.wait,
                     self.attrs))
        return False

    def set(self, key, value) -> None:
        """Attach an attribute (kept with the span when it ends)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value


def span(name: str, trace_id=None, wait: bool = False):
    """A context manager around one piece of host work.  ``wait`` marks
    time the host spends blocked (on the card, a lock or a queue)."""
    if not _on:
        return NOOP
    return _Live(name, trace_id, wait)


def enabled() -> bool:
    return _on


def current() -> Optional[Tuple[int, object]]:
    """``(span id, trace id)`` of this thread's innermost open span, or
    None (also when the tracer is off)."""
    if not _on:
        return None
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    return st[-1].id, st[-1].trace_id


def record(name: str, start_ns: int, end_ns: int, trace_id=None,
           parent: int = 0, wait: bool = False, attrs=None) -> None:
    """Record a span whose ends were read apart (on two threads, say)."""
    if _on:
        sid = next(_ids)
        _append(Span(name, start_ns, end_ns, sid, parent,
                     sid if trace_id is None else trace_id,
                     threading.get_ident(), wait, attrs))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already kept stay until :func:`take`."""
    global _on
    _on = False


def take() -> Tuple[List[Span], int]:
    """``(spans, dropped)``: the kept spans in the order they ended and
    the count dropped past :data:`CAPACITY`, both cleared."""
    global _store, _dropped
    out, _store = _store, []
    dropped, _dropped = next(_dropped), itertools.count()
    return out, dropped
