"""CLI: cluster lifecycle + state inspection + microbenchmark.

Reference: python/ray/scripts/scripts.py (`ray start/stop/status/...`,
`ray microbenchmark`, `ray list ...` via util/state/state_cli.py).

Usage: python -m ray_tpu_torch.scripts.cli <command> [...]

The port of ``ray_tpu/scripts/cli.py``: every subcommand and flag of the
JAX CLI, plus ``start --head`` (the head is the only node ``start``
starts) and ``--device`` on the commands that start a cluster (``start``
and ``microbenchmark``): ``cuda`` (the default) advertises the cards the
host has and fails without one, ``cpu`` advertises none unless
``--resources`` names ``GPU``. The address file lives in the port's
session root.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def cmd_start(args):
    """Start a head node that outlives this command (ray start --head)."""
    from ray_tpu_torch._private.node import NodeSupervisor

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.device == "cpu":
        resources.setdefault("GPU", 0.0)
    elif "GPU" not in resources:
        from ray_tpu_torch.util.accelerators import num_gpus_on_host

        if not num_gpus_on_host():
            print("no CUDA card on this host; pass --device cpu for a head "
                  "without one", file=sys.stderr)
            sys.exit(1)
    supervisor = NodeSupervisor(resources=resources,
                                labels=json.loads(args.labels or "{}"))
    address = supervisor.start_head()
    os.makedirs(os.path.dirname(os.path.abspath(args.address_file)),
                exist_ok=True)
    with open(args.address_file, "w") as f:
        f.write(address)
    print(f"head started; GCS at {address} (address file: {args.address_file})",
          flush=True)
    if args.include_dashboard:
        dash = supervisor.start_dashboard(port=args.dashboard_port)
        print(f"dashboard at http://{dash}", flush=True)
    if args.client_server_port:
        import threading

        import ray_tpu_torch
        from ray_tpu_torch.util.client import start_client_server

        ray_tpu_torch.init(address=address)

        def _serve_clients():
            try:
                start_client_server(port=args.client_server_port)
            except Exception as e:  # surface bind failures
                print(f"client server FAILED: {e}", file=sys.stderr,
                      flush=True)

        threading.Thread(target=_serve_clients, daemon=True).start()
        print(f"client endpoint: ray-tpu://<this-host>:"
              f"{args.client_server_port} (watch for the 'listening on' "
              "line)", flush=True)
    print("press Ctrl-C to stop", flush=True)
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    if args.client_server_port:
        ray_tpu_torch.shutdown()  # the proxy's driver, before its cluster
    supervisor.stop()


def _connect(args):
    import ray_tpu_torch

    address = args.address
    if not address and os.path.exists(args.address_file):
        address = open(args.address_file).read().strip()
    if not address:
        print("no --address given and no address file found", file=sys.stderr)
        sys.exit(1)
    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def _status_payload():
    """Fleet summary + per-job goodput column: the status view answers
    "is the cluster healthy AND are the jobs on it productive" without a
    second command. Goodput is best-effort — a cluster with no tagged
    jobs (or a pre-goodput GCS) just shows an empty column."""
    from ray_tpu_torch.util.state import goodput, summarize_cluster

    out = summarize_cluster()
    try:
        out["goodput"] = {
            name: round(float(view.get("goodput_fraction", 0.0)), 4)
            for name, view in sorted(goodput().items())}
    except Exception:
        out["goodput"] = {}
    return out


def cmd_status(args):
    _connect(args)
    print(json.dumps(_status_payload(), indent=2))


def cmd_list(args):
    _connect(args)
    from ray_tpu_torch.util import state

    fn = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "jobs": state.list_jobs,
        "placement-groups": state.list_placement_groups,
    }[args.what]
    print(json.dumps(fn(), indent=2, default=str))


def cmd_job(args):
    """ray job submit/status/logs/list/stop (reference: job CLI in
    dashboard/modules/job/cli.py)."""
    _connect(args)
    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient()
    if args.job_command == "submit":
        renv = json.loads(args.runtime_env) if args.runtime_env else None
        sid = client.submit_job(entrypoint=" ".join(args.entrypoint),
                                runtime_env=renv)
        print(sid)
        if args.wait:
            status = client.wait_until_finished(sid, timeout=args.timeout)
            print(status)
            print(client.get_job_logs(sid), end="")
            sys.exit(0 if status == "SUCCEEDED" else 1)
    elif args.job_command == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_command == "logs":
        print(client.get_job_logs(args.submission_id), end="")
    elif args.job_command == "list":
        print(json.dumps(client.list_jobs(), indent=2, default=str))
    elif args.job_command == "stop":
        print(client.stop_job(args.submission_id))


def cmd_timeline(args):
    """ray-tpu timeline: export a chrome://tracing JSON of task spans
    (reference: `ray timeline`). ``--from-gcs`` renders the task flow
    graph from the GCS task-event ring instead (works without tracing
    enabled; same payload as ``GET /api/timeline``)."""
    _connect(args)

    if args.from_gcs:
        from ray_tpu_torch.util.state import get_timeline

        trace = get_timeline(job_id=args.job_id or None)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        n = len(trace["traceEvents"])
    else:
        from ray_tpu_torch.util import tracing

        n = tracing.export_chrome_trace(args.out)
    print(f"wrote {n} events to {args.out} (open in chrome://tracing)")


def cmd_health(args):
    """ray-tpu health: the GCS cluster-health report (stuck tasks,
    straggler nodes, dead-zygote/pool starvation)."""
    _connect(args)
    import time as _t

    from ray_tpu_torch.util.state import cluster_health

    health = cluster_health(scan=args.scan)
    if args.json:
        print(json.dumps(health, indent=2, default=str))
        return
    ts = _t.strftime("%H:%M:%S", _t.localtime(health.get("ts", 0)))
    print(f"[{health.get('status', 'unknown').upper()}] scanned {ts} "
          f"(scan #{health.get('scan_count', 0)}, every "
          f"{health.get('scan_interval_s', 0):g}s, "
          f"{health.get('nodes_alive', 0)} nodes alive)")
    for f in health.get("findings", []):
        detail = " ".join(f"{k}={v}" for k, v in f.items()
                          if k not in ("kind", "severity"))
        print(f"  {f['severity']:7} {f['kind']}: {detail}")
    if not health.get("findings"):
        print("  no findings")


def cmd_goodput(args):
    """ray-tpu goodput: per-job wall-clock attribution ledgers — where
    each job's seconds went (step_compute, collective_wait, input_stall,
    ckpt_pause, compile, reform_downtime, bubble, overhead, idle) plus
    the derived goodput_fraction; same payload as ``GET /api/goodput``."""
    _connect(args)
    from ray_tpu_torch.util.state import goodput as state_goodput

    jobs = state_goodput(job=args.job or None)
    if args.json:
        print(json.dumps(jobs, indent=2, default=str))
        return
    if not jobs:
        print("no goodput ledgers (no tagged jobs have reported yet)")
        return
    for name, view in jobs.items():
        wall = view.get("wall_s", 0.0)
        frac = view.get("goodput_fraction", 0.0)
        mfu = view.get("mfu")
        head = (f"{name}: wall {wall:.1f}s  goodput {frac:.1%}  "
                f"procs {view.get('fresh_procs', 0)}/{view.get('procs', 0)}")
        if mfu is not None:
            head += f"  mfu {mfu:.3f}"
        print(head)
        buckets = view.get("buckets", {})
        for bucket, secs in sorted(buckets.items(),
                                   key=lambda kv: -kv[1]):
            if secs <= 0:
                continue
            share = secs / wall if wall > 0 else 0.0
            print(f"  {bucket:16} {secs:10.2f}s  {share:6.1%}")
        counters = view.get("counters", {})
        if counters:
            print("  counters: " + " ".join(
                f"{k}={counters[k]:g}" for k in sorted(counters)))


def cmd_events(args):
    """ray-tpu events: recent structured cluster events (reference: the
    export-event pipeline surfaced by the dashboard aggregator)."""
    _connect(args)
    import time as _t

    from ray_tpu_torch.util import events as events_mod

    for e in events_mod.list_events(source=args.source or None,
                                    severity=args.severity or None,
                                    limit=args.limit):
        ts = _t.strftime("%H:%M:%S", _t.localtime(e.get("ts", 0)))
        meta = " ".join(f"{k}={v}" for k, v in (e.get("metadata") or {}).items())
        print(f"{ts} [{e.get('severity')}] {e.get('source')}: "
              f"{e.get('message')} {meta}")


def cmd_tasks(args):
    """ray-tpu tasks: task lifecycle records and the `ray summary tasks`
    analog (reference: `ray list tasks` / `ray summary tasks` backed by
    GcsTaskManager)."""
    _connect(args)
    import time as _t

    from ray_tpu_torch.util import state

    if args.summary:
        print(json.dumps(state.summarize_tasks(), indent=2))
        return
    if args.task_id:
        print(json.dumps(state.get_task(args.task_id), indent=2, default=str))
        return
    tasks = state.list_tasks(name=args.name or None,
                             state_filter=args.state or None,
                             limit=args.limit)
    for t in tasks:
        start = _t.strftime("%H:%M:%S",
                            _t.localtime(t.get("start_ts", 0)))
        transitions = "->".join(e["state"] for e in t.get("events", []))
        err = f" err={t['error']!r}" if t.get("error") else ""
        print(f"{start} {t['task_id'][:16]} {t['name'] or '?':32} "
              f"[{t['state']}] attempt={t['attempt']} {transitions}{err}")


def cmd_workers(args):
    """ray-tpu workers: per-node worker-pool / provisioning-plane stats
    (reference surface: the dashboard's /api/workers; backed by the KV
    mirror each raylet's metrics loop publishes)."""
    _connect(args)
    from ray_tpu_torch.util import state

    pools = state.list_worker_pools()
    if args.json:
        print(json.dumps(pools, indent=2, default=str))
        return
    for key, entry in sorted(pools.items()):
        p = entry.get("pool", {})
        zyg = "zygote=up" if p.get("zygote_alive") else (
            "zygote=DOWN" if p.get("enabled") else "zygote=off")
        print(f"{entry.get('node', key)[:12]} {zyg} "
              f"warm={p.get('warm_default_env', 0)}/{p.get('warm_target', 0)} "
              f"workers={p.get('total_workers', 0)} "
              f"hits={p.get('hits', 0)} misses={p.get('misses', 0)} "
              f"forks={p.get('forks', 0)} cold={p.get('cold_spawns', 0)} "
              f"restarts={p.get('zygote_restarts', 0)}")


def cmd_serve(args):
    """ray-tpu serve: serve autoscale-plane state per deployment
    (reference surface: the dashboard's /api/serve; backed by the KV
    mirror the serve controller publishes every autoscale tick)."""
    _connect(args)
    import time as _t

    from ray_tpu_torch.util import state

    deployments = state.serve_state()
    if args.json:
        print(json.dumps(deployments, indent=2, default=str))
        return
    if not deployments:
        print("no serve deployments")
        return
    for name, entry in sorted(deployments.items()):
        rollup = entry.get("rollup") or {}
        qp99 = rollup.get("queue_p99_s")
        slo = entry.get("slo") or {}
        print(f"{name}: replicas={entry.get('replicas', 0)}/"
              f"{entry.get('target', 0)} "
              f"draining={entry.get('draining', 0)} "
              f"arrival={rollup.get('arrival_rate', 0.0):.2f}/s "
              f"queue_p99={'n/a' if qp99 is None else '%.3fs' % qp99}"
              + (f" slo(queue)={slo.get('queue_target_s')}s"
                 if slo.get("queue_target_s") is not None else ""))
        for tr in entry.get("transitions", [])[-args.transitions:]:
            ts = _t.strftime("%H:%M:%S", _t.localtime(tr.get("ts", 0)))
            print(f"  {ts} scale {tr.get('direction', '?'):4} "
                  f"{tr.get('from')}->{tr.get('to')}: {tr.get('reason')}")


def cmd_ckpt(args):
    """ray-tpu ckpt: inspect and manage checkpoint-plane stores
    (ray_tpu_torch/ckpt/).

    With ``--root`` the subcommands operate directly on a store directory
    (no cluster needed); without it, ``list`` shows every store registered
    with the GCS (KV ns ``ckpt``). ``mirror``/``evict``/``verify`` drive
    a tiered store's remote tier through its persisted TIER descriptor."""
    if args.ckpt_command == "sweep":
        # cluster-side: force the GCS retention sweeper over every
        # registered store now and print its reports
        _connect(args)
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod.global_worker()
        out = core._run(core._gcs_call("CkptSweep", {}), 300.0)
        print(json.dumps(out["reports"], indent=2, default=str))
        return
    if not args.root:
        _connect(args)
        from ray_tpu_torch.util.state import list_checkpoints

        print(json.dumps(list_checkpoints(), indent=2, default=str))
        return
    from ray_tpu_torch.ckpt import CheckpointStore, diff_manifests

    if args.ckpt_command in ("mirror", "evict", "verify"):
        from ray_tpu_torch.ckpt.tier import attach

        tiered = attach(args.root, mirror=False)
        ckpt_id = getattr(args, "ckpt_id", "") or None
        if args.ckpt_command == "mirror":
            out = tiered.mirror_now(ckpt_id)
        elif args.ckpt_command == "evict":
            out = tiered.evict_local(ckpt_id or tiered.latest_id())
        else:
            out = tiered.verify(ckpt_id, deep=args.deep)
        print(json.dumps(out, indent=2, default=str))
        if args.ckpt_command == "verify" and not out.get("ok"):
            sys.exit(1)
        return

    store = CheckpointStore(args.root)
    if args.ckpt_command == "list":
        rows = store.stats()
        print(json.dumps(rows, indent=2, default=str))
    elif args.ckpt_command == "inspect":
        man = store.read(args.ckpt_id) if args.ckpt_id else store.latest()
        if man is None:
            print("no committed checkpoint", file=sys.stderr)
            sys.exit(1)
        out = man.to_json()
        if not args.chunks:
            # per-leaf chunk lists are the bulk of a big manifest; show
            # counts unless asked
            out["leaves"] = {
                k: {"kind": v["kind"], "shape": v["shape"],
                    "dtype": v["dtype"], "num_chunks": len(v["chunks"])}
                for k, v in out["leaves"].items()}
        print(json.dumps(out, indent=2, default=str))
    elif args.ckpt_command == "diff":
        print(json.dumps(diff_manifests(store.read(args.a),
                                        store.read(args.b)),
                         indent=2, default=str))


def cmd_microbenchmark(args):
    import ray_tpu_torch

    if args.address or os.path.exists(args.address_file):
        _connect(args)
    else:
        ray_tpu_torch.init(num_cpus=args.num_cpus or None, device=args.device)
    from ray_tpu_torch._private.microbenchmark import main as bench_main

    for row in bench_main(duration=args.duration):
        print(json.dumps(row))
    ray_tpu_torch.shutdown()


def cmd_stack(args):
    """`ray-tpu stack` (reference: `ray stack` / dashboard py-spy): sample a
    worker's call stacks, or take a tracemalloc memory snapshot."""
    _connect(args)
    from ray_tpu_torch.util.state import get_node_stats, list_nodes, profile_worker

    nodes = [n for n in list_nodes() if n["alive"]]
    node = next((n for n in nodes
                 if n["node_id"].startswith(args.node or "")), None)
    if node is None:
        print(f"no node matching {args.node!r}")
        return
    if args.pid is None:
        stats = get_node_stats(node["address"], agent=True)
        for w in stats["agent"]["workers"]:
            print(json.dumps(w))
        return
    if args.memory:
        out = profile_worker(node["address"], args.pid, kind="memory",
                             action=args.memory_action)
    else:
        out = profile_worker(node["address"], args.pid, kind="stacks",
                             duration_s=args.duration)
    print(json.dumps(out.get("profile", out), indent=1))


def main(argv=None):
    from ray_tpu_torch._private.config import RAY_CONFIG

    parser = argparse.ArgumentParser(prog="ray-tpu")
    parser.add_argument("--address", default="")
    parser.add_argument("--address-file", default=os.path.join(
        RAY_CONFIG.torch_session_root, "head_address"))
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start a head node")
    p.add_argument("--head", action="store_true",
                   help="start the head (the only node `start` starts)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", default="")
    p.add_argument("--labels", default="")
    p.add_argument("--include-dashboard", action="store_true")
    p.add_argument("--dashboard-port", type=int, default=8265)
    p.add_argument("--client-server-port", type=int, default=0,
                   help="serve a ray-tpu:// client endpoint on this port")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="advertise the host's cards (cuda) or none (cpu)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("status", help="cluster summary")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster entities")
    p.add_argument("what", choices=["nodes", "actors", "jobs", "placement-groups"])
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("job", help="submit and manage jobs")
    jsub = p.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--runtime-env", default="", help="JSON runtime env")
    js.add_argument("--wait", action="store_true")
    js.add_argument("--timeout", type=float, default=600.0)
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("submission_id")
    jsub.add_parser("list")
    p.set_defaults(fn=cmd_job)

    p = sub.add_parser("timeline", help="export chrome://tracing task timeline")
    p.add_argument("--out", default="timeline.json")
    p.add_argument("--from-gcs", action="store_true",
                   help="render from the GCS task-event ring (no tracing "
                        "needed) instead of the span table")
    p.add_argument("--job-id", default="", help="filter by job (with --from-gcs)")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("health", help="cluster-health report "
                                      "(stuck/straggler/pool findings)")
    p.add_argument("--scan", action="store_true",
                   help="force a scan now instead of the last periodic one")
    p.add_argument("--json", action="store_true", help="raw JSON output")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser("goodput", help="per-job goodput ledgers "
                                       "(wall-clock attribution buckets)")
    p.add_argument("--job", default="", help="filter to one run name")
    p.add_argument("--json", action="store_true", help="raw JSON output")
    p.set_defaults(fn=cmd_goodput)

    p = sub.add_parser("events", help="recent structured cluster events")
    p.add_argument("--source", default="")
    p.add_argument("--severity", default="")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("tasks", help="task lifecycle records / summary")
    p.add_argument("--summary", action="store_true",
                   help="per-function counts by state (ray summary tasks)")
    p.add_argument("--task-id", default="", help="one task's full record")
    p.add_argument("--name", default="", help="filter by function name")
    p.add_argument("--state", default="", help="filter by lifecycle state")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_tasks)

    p = sub.add_parser("workers", help="per-node worker-pool / "
                                       "provisioning-plane stats")
    p.add_argument("--json", action="store_true", help="raw JSON output")
    p.set_defaults(fn=cmd_workers)

    p = sub.add_parser("serve", help="serve autoscale-plane state "
                                     "(replicas, rates, scale history)")
    p.add_argument("--json", action="store_true", help="raw JSON output")
    p.add_argument("--transitions", type=int, default=4,
                   help="scale transitions to show per deployment")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("ckpt", help="checkpoint-plane stores "
                                    "(list/inspect/diff)")
    csub = p.add_subparsers(dest="ckpt_command", required=False)
    cl = csub.add_parser("list", help="store summary (all registered "
                                      "stores without --root)")
    cl.add_argument("--root", default="", help="store directory")
    ci = csub.add_parser("inspect", help="one manifest (default: latest)")
    ci.add_argument("--root", required=True)
    ci.add_argument("ckpt_id", nargs="?", default="")
    ci.add_argument("--chunks", action="store_true",
                    help="include full per-leaf chunk lists")
    cd = csub.add_parser("diff", help="chunk delta between two manifests")
    cd.add_argument("--root", required=True)
    cd.add_argument("a")
    cd.add_argument("b")
    cm = csub.add_parser("mirror", help="replicate a checkpoint to the "
                                        "store's remote tier now")
    cm.add_argument("--root", required=True)
    cm.add_argument("ckpt_id", nargs="?", default="")
    ce = csub.add_parser("evict", help="drop local chunk bytes of a "
                                       "fully-mirrored checkpoint")
    ce.add_argument("--root", required=True)
    ce.add_argument("ckpt_id", nargs="?", default="")
    cv = csub.add_parser("verify", help="check a checkpoint's remote "
                                        "durability (exit 1 if not ok)")
    cv.add_argument("--root", required=True)
    cv.add_argument("ckpt_id", nargs="?", default="")
    cv.add_argument("--deep", action="store_true",
                    help="fetch and sha256-verify every chunk")
    cs = csub.add_parser("sweep", help="force the GCS retention sweeper "
                                       "over every registered store now")
    cs.add_argument("--root", default="")  # unused; uniform surface
    p.set_defaults(fn=cmd_ckpt, ckpt_command="list", root="")

    p = sub.add_parser("microbenchmark", help="run the core perf suite")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device of the cluster it starts without one")
    p.set_defaults(fn=cmd_microbenchmark)

    p = sub.add_parser("stack", help="profile a worker (stacks or memory)")
    p.add_argument("--node", default="", help="node id prefix (default: head)")
    p.add_argument("--pid", type=int, default=None,
                   help="worker pid (omit to list workers)")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--memory", action="store_true")
    p.add_argument("--memory-action", default="snapshot",
                   choices=["start", "snapshot", "stop"])
    p.set_defaults(fn=cmd_stack)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
