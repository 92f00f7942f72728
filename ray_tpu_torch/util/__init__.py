"""Observability of the port: the metrics registry (``metrics``), causal
spans with a chrome://tracing export (``tracing``) and the goodput ledger
(``goodput``), the counterparts of ``ray_tpu/util``'s modules of those
names, GPU detection for the raylet (``accelerators``, the port of
the module that detects TPU chips), and placement groups and scheduling
strategies (``placement_group``, ``scheduling_strategies``), and the state
API over the GCS (``state``: nodes, actors, tasks, timelines, goodput and
the Dataset's stats), and structured cluster events (``events``). Metrics,
spans, events and the goodput ledger ship to the GCS inside the port's
runtime."""
