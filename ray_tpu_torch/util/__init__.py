"""Observability of the port: the metrics registry (``metrics``), causal
spans with a chrome://tracing export (``tracing``) and the goodput ledger
(``goodput``), the counterparts of ``ray_tpu/util``'s modules of those
names. Without the runtime they keep what they record in the process."""
