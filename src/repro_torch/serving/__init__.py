"""Paged continuous-batching serving (the port of ``repro.serving``)."""
