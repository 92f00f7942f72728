"""The port's CLI (``python -m ray_tpu_torch.scripts.cli``), on the CPU.

Its argparse tree holds every subcommand, flag, positional, choice and
default of the JAX CLI (``ray_tpu/scripts/cli.py``), and adds only
``start --head`` and ``--device`` on the two commands that start a cluster;
the address file's default moves to the port's session root. Then the CLI
drives a head of its own: ``start --head --include-dashboard --device cpu``
as a subprocess, ``status``, ``list``, ``job submit --wait`` with a working
directory, ``job list`` / ``status`` / ``logs``, ``timeline --from-gcs``,
``health``, ``stack``, a short ``microbenchmark`` against it, and SIGINT.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what the port adds to the JAX tree, by subcommand
ADDED = {("start",): {"--head", "--device"}, ("microbenchmark",): {"--device"}}


class _Parsed(Exception):
    pass


def _parser(module, monkeypatch):
    """The parser ``module.main`` builds, caught at its ``parse_args``."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            module.main([])
    return seen["parser"]


def _tree(parser, path=()):
    """path -> {flag or positional: (choices, default, nargs)}."""
    out = {path: {}}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_tree(sub, path + (name,)))
            continue
        if isinstance(action, argparse._HelpAction):
            continue
        key = max(action.option_strings, key=len) if action.option_strings \
            else action.dest
        out[path][key] = (action.choices, action.default, action.nargs)
    return out


def test_argparse_tree_matches_the_jax_cli(monkeypatch):
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch._private.config import RAY_CONFIG
    from ray_tpu_torch.scripts import cli as tcli

    want = _tree(_parser(jcli, monkeypatch))
    got = _tree(_parser(tcli, monkeypatch))
    assert sorted(got) == sorted(want)
    assert len(want) > 20  # every subcommand, ckpt's and job's included
    for path, flags in want.items():
        extra = set(got[path]) - set(flags)
        assert extra == ADDED.get(path, set()), path
        for flag, spec in flags.items():
            if path == () and flag == "--address-file":
                assert got[path][flag][1] == os.path.join(
                    RAY_CONFIG.torch_session_root, "head_address")
                continue
            assert got[path][flag] == spec, (path, flag)
    for path, flags in ADDED.items():
        if "--device" in flags:
            assert got[path]["--device"] == (["cuda", "cpu"], "cuda", None)


def _cli(*args, address_file, timeout=120, check=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address-file",
         address_file, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    if check:
        assert out.returncode == 0, (args, out.stdout[-2000:],
                                     out.stderr[-3000:])
    return out


def test_cli_drives_a_head_with_the_dashboard(tmp_path):
    import urllib.request

    address_file = str(tmp_path / "head_address")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address-file",
         address_file, "start", "--head", "--include-dashboard", "--device",
         "cpu", "--num-cpus", "4", "--dashboard-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        dashboard, lines = None, []
        deadline = time.monotonic() + 60
        while dashboard is None and time.monotonic() < deadline:
            line = head.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("dashboard at http://"):
                dashboard = line.split("http://", 1)[1].strip()
        with urllib.request.urlopen(f"http://{dashboard}/api/nodes",
                                    timeout=30) as r:
            nodes = json.loads(r.read())
        assert [n["total_resources"]["GPU"] for n in nodes] == [0.0]

        status = json.loads(_cli("status", address_file=address_file).stdout)
        assert status["num_nodes"] == 1 and "goodput" in status
        listed = json.loads(_cli("list", "nodes",
                                 address_file=address_file).stdout)
        assert len(listed) == 1

        work = tmp_path / "work"
        work.mkdir()
        (work / "entry.py").write_text(
            "import os\nprint('entry ran', os.environ['CLI_VAR'],\n"
            "      os.path.exists('entry.py'))\n")
        renv = json.dumps({"working_dir": str(work),
                           "env_vars": {"CLI_VAR": "v1"}})
        out = _cli("job", "submit", "--wait", "--runtime-env", renv,
                   sys.executable, "entry.py", address_file=address_file)
        sid, state = out.stdout.split("\n")[:2]
        assert state == "SUCCEEDED" and "entry ran v1 True" in out.stdout
        jobs = json.loads(_cli("job", "list", address_file=address_file)
                          .stdout)
        assert [j["status"] for j in jobs if j["submission_id"] == sid] == [
            "SUCCEEDED"]
        assert _cli("job", "status", sid, address_file=address_file
                    ).stdout.strip() == "SUCCEEDED"
        assert "entry ran v1 True" in _cli("job", "logs", sid,
                                           address_file=address_file).stdout

        trace = tmp_path / "timeline.json"
        _cli("timeline", "--from-gcs", "--out", str(trace),
             address_file=address_file)
        assert "traceEvents" in json.loads(trace.read_text())
        health = _cli("health", address_file=address_file).stdout
        assert health.startswith("[OK] scanned"), health
        workers = [json.loads(line) for line in _cli(
            "stack", address_file=address_file).stdout.splitlines()]
        assert workers and all(w["rss_mb"] > 0 for w in workers)

        rows = [json.loads(line) for line in _cli(
            "microbenchmark", "--duration", "0.2",
            address_file=address_file, timeout=180).stdout.splitlines()]
        assert [r["name"] for r in rows] == [
            "tasks_sync_per_s", "tasks_async_batch_per_s",
            "tasks_pipeline1k_per_s", "actor_calls_sync_per_s",
            "actor_calls_async_batch_per_s", "async_actor_calls_batch_per_s",
            "put_small_per_s", "put_get_10MB_roundtrips_per_s"]
        assert all(r["rate_per_s"] > 0 for r in rows)
    finally:
        head.send_signal(signal.SIGINT)
        assert head.wait(timeout=60) == 0


def test_start_without_a_card_fails(tmp_path):
    """``start`` on the default ``--device cuda`` exits 1 on a host without
    a card, before it writes an address file."""
    from ray_tpu_torch.util.accelerators import num_gpus_on_host

    if num_gpus_on_host():
        pytest.skip("this host has a card")
    address_file = str(tmp_path / "head_address")
    out = _cli("start", "--head", address_file=address_file, check=False,
               timeout=60)
    assert out.returncode == 1 and "--device cpu" in out.stderr
    assert not os.path.exists(address_file)


def test_start_serves_a_client_endpoint(tmp_path):
    """``start --device cpu --client-server-port P`` serves ``ray-tpu://``
    on P: a client in this process reaches the head's cluster through it,
    and SIGINT stops the head cleanly."""
    import socket

    import ray_tpu_torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    address_file = str(tmp_path / "head_address")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address-file",
         address_file, "start", "--head", "--device", "cpu", "--num-cpus",
         "2", "--client-server-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = head.stdout.readline()
            lines.append(line)
            if "listening on" in line or head.poll() is not None:
                break
        assert "listening on" in lines[-1], "".join(lines)
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(address=f"ray-tpu://127.0.0.1:{port}")
        try:
            @ray_tpu_torch.remote
            def double(x):
                return 2 * x

            assert ray_tpu_torch.get(double.remote(21), timeout=120) == 42
            assert ray_tpu_torch.cluster_resources()["CPU"] == 2.0
        finally:
            ray_tpu_torch.shutdown()
    finally:
        head.send_signal(signal.SIGINT)
        assert head.wait(timeout=60) == 0, head.stdout.read()[-3000:]
