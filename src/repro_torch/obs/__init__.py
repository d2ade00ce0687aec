"""Host-side observability of the port: the Chrome-trace tracer behind
``--trace`` (``trace``), the live communication ledger (``ledger``) and the
typed metrics registry with the kernel-dispatch counter (``metrics``).
With no tracer active, every instrumentation site is one ``is None`` test:
no host copy, no synchronisation."""
from repro_torch.obs import ledger, metrics, trace  # noqa: F401
