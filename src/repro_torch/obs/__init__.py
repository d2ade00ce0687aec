"""Host-side observability of the port: the typed metrics registry
(``metrics``). Tracing and the communication ledger are not ported
(ROADMAP.md queue A)."""
