"""Typed errors of the serving stack (a copy of ``repro.fault.errors``)."""
