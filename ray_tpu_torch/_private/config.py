"""Env-overridable configuration: the port of ``ray_tpu/_private/config.py``.

Equivalent of the reference's ``RAY_CONFIG`` macro table
(``src/ray/common/ray_config_def.h``): every knob has a typed default and can
be overridden per process with a ``RAY_TPU_<NAME>`` environment variable,
the JAX package's names and defaults, so one environment configures both
packages' GCS, raylets and workers alike. Where the port differs:

- ``zygote_preimport_torch`` replaces ``zygote_preimport_jax`` (off by
  default, as that is);
- ``torch_session_root`` replaces ``session_root``, so the port's sessions
  (``session_latest``, logs, address files) live apart from the JAX
  runtime's even when ``RAY_TPU_SESSION_ROOT`` is set;
- a knob nothing in the port reads is left out (most have no reader in
  the JAX package either); one whose reader is a library still to port
  comes back with it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"


def _coerce(value: str, default: Any) -> Any:
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, (dict, list)):
        return json.loads(value)
    return value


class _ConfigRegistry:
    """Typed config table; attribute access returns the (env-overridden) value."""

    _defs: Dict[str, Any] = {}

    def define(self, name: str, default: Any, doc: str = "") -> None:
        self._defs[name] = default

    def __getattr__(self, name: str) -> Any:
        try:
            default = self._defs[name]
        except KeyError:
            raise AttributeError(f"unknown config {name!r}")
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            return _coerce(env, default)
        return default

    def items(self):
        return {k: getattr(self, k) for k in self._defs}.items()


RAY_CONFIG = _ConfigRegistry()
_d = RAY_CONFIG.define

# --- networking / rpc ---
_d("rpc_connect_timeout_s", 10.0)
_d("rpc_call_timeout_s", 60.0)
_d("rpc_retry_base_delay_ms", 50)
_d("rpc_retry_max_delay_ms", 2000)
_d("rpc_max_retries", 5)
# ceiling on blind reconnect+retry of calls that provably never reached the
# peer (safe for non-idempotent calls); keeps dead-peer detection fast
_d("rpc_presend_retry_timeout_s", 15.0)
# after a GCS restart, how often to poll a replayed RUNNING job's driver
# before declaring it gone and reaping the job's actors
_d("gcs_driver_reattach_grace_s", 10.0)
# unplaceable-demand entries older than this drop out of the autoscaler view
# (live demand refreshes itself via scheduling retries)
_d("autoscaler_demand_ttl_s", 15.0)
# Chaos injection (reference: src/ray/rpc/rpc_chaos.h). Format:
#   "Method=N" -> fail the first N calls of Method;
#   "Method=N:p" -> after the first N, fail with probability p.
_d("testing_rpc_failure", "")
_d("testing_rpc_reply_failure", "")  # handler runs, reply dropped (zombies)
_d("testing_rpc_delay_ms", 0)

# --- GCS / control plane ---
_d("health_check_period_ms", 1000)
_d("health_check_timeout_ms", 5000)

# --- raylet / scheduling ---
_d("max_workers_per_node", 64)
_d("lease_spillback_max_hops", 4)
# smallest total argument footprint that makes locality steer lease placement
_d("locality_min_arg_bytes", 64 * 1024)
# queued pulls with no remaining waiters are cancelled after this long
_d("object_pull_interest_ttl_s", 30.0)
_d("scheduler_spread_threshold", 0.5)  # hybrid policy: pack below, spread above
_d("worker_start_timeout_s", 60.0)
# how long a task waits for a feasible node (an autoscaler may add one)
# before failing with a scheduling error
_d("infeasible_task_timeout_s", 300.0)

_d("object_pull_concurrency", 8)  # concurrent inbound transfers per node

# --- OOM defense (reference: memory_monitor.h:52) ---
_d("memory_usage_threshold", 0.95)
_d("memory_monitor_refresh_ms", 500)
# 0 = node-level /proc/meminfo accounting; >0 = budget over worker RSS
_d("memory_monitor_capacity_bytes", 0)

# --- object store ---
_d("object_store_memory", 2 * 1024**3)
_d("object_inline_max_bytes", 100 * 1024)
_d("object_chunk_bytes", 8 * 1024**2)
_d("object_spill_dir", "")  # default: <session>/spill
# spill backend: "" / "filesystem" | "s3://bucket/prefix" | "module:Class"
_d("object_spill_storage", "")
_d("object_pull_timeout_s", 120.0)
_d("object_store_backend", "auto")  # "auto" | "cpp" | "shm"
# pre-touch this much of the arena at start: first-touch page faults on
# /dev/shm cost ~65ms per 10MB on some hosts vs ~1ms warm
_d("object_store_prewarm_bytes", 256 * 1024**2)

# --- tasks / actors ---
_d("task_max_retries", 3)
_d("max_pending_lease_requests", 16)
_d("worker_startup_concurrency", 2)  # concurrent cold worker spawns per node
_d("prestart_workers", 2)  # idle workers spawned at raylet start

# --- worker provisioning plane (reference: worker_pool.h prestart/adoption) ---
# zygote prefork pool: a per-raylet zygote process pre-imports the heavy
# stack once and forks ready workers on demand; lease grants ADOPT a warm
# worker instead of paying a cold interpreter+import start-up
_d("worker_zygote_enabled", True)
_d("zygote_preimport_torch", False)  # pre-import torch in the zygote (threads!)
_d("zygote_fork_timeout_s", 20.0)
# warm default-runtime-env workers the replenish loop keeps forked AND
# registered so a lease grant is pure adoption (0 disables replenish; the
# one-shot prestart above still applies)
_d("worker_pool_warm_target", 2)
# multi-grant leases: one RequestWorkerLease can return up to this many
# grants when the owner asks (count=N); warm workers are granted first and
# the remainder is forked from the zygote (spawn-backed top-up)
_d("lease_max_grants", 8)
# renv-keyed warm pool: also keep this many warm workers forked for the
# most-recently-leased non-default runtime env (0 disables; hot renvs then
# always pay a fork on grant)
_d("worker_pool_warm_target_renv", 2)
# GCS resource_view coalescing tick: availability changes are folded into
# one batched publish per tick (membership changes still flush immediately)
_d("gcs_resource_view_tick_s", 0.1)
_d("max_lineage_bytes", 64 * 1024**2)
# ownership-based distributed refcounting (reference: reference_counter.h:44)
_d("distributed_refcounting", 1)
_d("free_grace_s", 1.0)  # settle delay before a zero-ref free (in-flight borrows)
_d("gcs_freed_tombstone_cap", 200000)  # bounded freed-object tombstone ring
# sustained unreachability before an owner declares a borrower dead and
# reclaims its borrows; borrowers re-assert every 30s, so partitions shorter
# than this are fully safe and longer ones only lose non-reconstructable data
_d("borrower_death_timeout_s", 120.0)
_d("borrow_debounce_s", 0.25)  # skip borrow RPCs for transient handles
_d("max_object_reconstructions", 5)

# --- observability (task events + metrics; reference: task_event_buffer.cc
# report interval + gcs_task_manager.cc per-job caps) ---
_d("task_events_flush_interval_s", 1.0)
_d("metrics_flush_interval_s", 10.0)
_d("gcs_task_events_max_per_job", 4096)  # per-job ring; drop-oldest beyond
_d("task_events_max_per_task", 64)  # transition entries kept per task
# sharded/pipelined GCS task-event ingestion: AddTaskEvents enqueues by
# task-id hash and returns; per-shard drain tasks merge in the background
_d("gcs_task_event_shards", 8)
_d("gcs_task_event_ingest_max", 65536)  # queued events per shard; drop beyond

# --- cluster health plane (metrics history + health monitor) ---
# two-tier metrics time-series ring kept by the GCS over the snapshots it
# already receives: a raw tier sampled every metrics_history_interval_s and
# a rollup tier aggregating raw points every metrics_history_rollup_s
_d("metrics_history_interval_s", 5.0)
_d("metrics_history_raw_points", 360)     # ~30 min of raw tier
_d("metrics_history_rollup_s", 60.0)
_d("metrics_history_rollup_points", 1440)  # ~24 h of rollup tier
# GCS health monitor: scans task events + metrics for stuck tasks,
# straggler nodes, and dead-zygote/pool starvation
_d("health_scan_interval_s", 5.0)
_d("health_stuck_min_s", 30.0)       # floor: RUNNING younger is never stuck
_d("health_stuck_p99_factor", 5.0)   # stuck if age > factor * per-fn p99
_d("health_stuck_fallback_s", 600.0)  # no completed samples for the fn yet
_d("health_straggler_factor", 3.0)   # outlier if > factor * cluster median
_d("health_warn_interval_s", 60.0)   # rate limit for health warning logs

# --- goodput ledger (per-job wall-clock attribution) ---
_d("goodput_enabled", True)
# findings ignore jobs with less than this much ledger wall time (startup
# transients would otherwise trip the fraction thresholds)
_d("goodput_min_wall_s", 5.0)
_d("goodput_recompile_storm_n", 3)     # recompiles within the window ->
_d("goodput_recompile_window_s", 300.0)  # recompile_storm finding
_d("goodput_input_bound_frac", 0.25)   # input_stall/wall over this -> finding
_d("goodput_ckpt_budget_s", 5.0)       # mean ckpt pause per save budget
# goodput_fraction this far (absolute) below the job's trailing-window
# mean -> goodput_regression finding; needs this many history points
_d("goodput_regression_drop", 0.1)
_d("goodput_regression_min_points", 6)

# --- checkpoint storage tier (ckpt/tier) ---
_d("ckpt_io_threads", 8)  # per-host parallel chunk transfer workers
# per-host in-flight payload byte cap for cross-tier chunk transfers
_d("ckpt_io_inflight_bytes", 256 * 1024**2)
# ranged reads separated by at most this many bytes coalesce into one GET
_d("ckpt_io_coalesce_gap", 64 * 1024)
_d("ckpt_mirror_enabled", True)  # TieredStore commits enqueue a mirror
_d("ckpt_multipart_bytes", 8 * 1024**2)  # bucket uploads split above this
# GCS-side retention sweeper cadence over opted-in stores (0 disables)
_d("ckpt_sweep_interval_s", 30.0)
# chunks younger than this are never reaped on any tier (in-flight saves
# and mirrors write chunks before the manifest that names them)
_d("ckpt_sweep_grace_s", 300.0)
# when set, train-run checkpoint stores become TieredStores mirroring to
# a bucket rooted here (one prefix per run); "" keeps them local-only
_d("ckpt_tier_root", "")

# --- serve ---
# failed health checks in a row before the controller replaces a replica
# that is not known dead (a replica building its model answers late)
_d("serve_health_strikes", 30)

# --- session ---
_d("torch_session_root",
   os.path.join(tempfile.gettempdir(), "ray_tpu_torch_sessions"))
