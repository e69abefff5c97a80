"""Deliberately broken programs, to show that the check catches them.

Each entry patches the port for the length of a ``with`` block; a run of
the harness inside it must come out with ``correct`` false.

Controls, each breaking one guarantee the configurations state:

- ``stale_reads``: every commit publishes the state of the commit before
  it under the new generation, so queries are answered one chunk stale;
- ``repair_skipped``: the update step never repairs its SCC labels (the
  partition left approximate).

Faults of the timed path:

- ``state_unchanged``: a super-chunk of steps returns its input state
  (the generation advanced, nothing applied);
- ``half_batch``: every step leaves out the upper half of its lanes;
- ``ack_altered``: the first ack of every super-chunk flipped;
- ``answer_altered``: the first answer of every Reachable batch flipped.

The patches act where the port's own modules look the names up, so a
step graph captured inside the block runs the broken step; the harness
drops its graphs at the end of every run.
"""
from __future__ import annotations

import contextlib


def _stale_reads():
    from repro_torch.core.service import SCCService
    orig = SCCService._apply_chunk

    def apply_chunk(self, kind, u, v):
        prev = self._head[0]
        ok = orig(self, kind, u, v)
        with self._commit_cv:
            self._head = (prev, self._gen)
        return ok
    return SCCService, "_apply_chunk", apply_chunk


def _repair_skipped():
    from repro_torch.core import dynamic

    def repair(cfg, src, dst, live, v_alive, ccid, m_del, straddle, u, v,
               graph):
        return ccid, dynamic._skipped(ccid)
    return dynamic, "_repair", repair


def _scan_wrapper(edit_ops=None, edit_out=None):
    from repro_torch.core import dynamic
    orig = dynamic.apply_batch_scan

    def scan(state, ops, cfg):
        if edit_ops is not None:
            ops = edit_ops(dynamic, ops)
        out = orig(state, ops, cfg)
        return edit_out(state, out) if edit_out is not None else out
    return dynamic, "apply_batch_scan", scan


def _state_unchanged():
    def keep(state, out):
        new, ok, ovf, stats = out
        return (state._replace(gen=new.gen), ok, ovf, stats)
    return _scan_wrapper(edit_out=keep)


def _half_batch():
    def halve(dynamic, ops):
        kind = ops.kind.clone()
        kind[..., kind.shape[-1] // 2:] = dynamic.NOP
        return dynamic.OpBatch(kind, ops.u, ops.v)
    return _scan_wrapper(edit_ops=halve)


def _ack_altered():
    def flip(state, out):
        new, ok, ovf, stats = out
        ok = ok.clone()
        ok[..., 0] = ~ok[..., 0]
        return new, ok, ovf, stats
    return _scan_wrapper(edit_out=flip)


def _answer_altered():
    from repro_torch.core import service
    orig = service.reachable_on

    def reachable_on(state, cfg, u, v):
        out = orig(state, cfg, u, v).copy()
        out[0] = ~out[0]
        return out
    return service, "reachable_on", reachable_on


CONTROLS = {"stale_reads": _stale_reads, "repair_skipped": _repair_skipped}
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "ack_altered": _ack_altered, "answer_altered": _answer_altered}


@contextlib.contextmanager
def broken(name: str):
    """The port with the control or fault ``name`` in place."""
    owner, attr, new = {**CONTROLS, **FAULTS}[name]()
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, old)
