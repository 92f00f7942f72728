"""Client mode (``ray-tpu://``) on the port: a mirror of
``tests/test_client_mode.py`` with a port host process (a CPU cluster and
the client proxy), plus a client whose ``__main__`` defines the function
and the class that run on the cluster, sent by value, and the autoscaler's
``request_resources`` through the proxy."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def start_host(tmp_path, num_cpus: int = 4):
    """A port cluster and its client proxy in a process of their own: the
    test process reaches it only through the returned ``ray-tpu://``
    address. Returns (process, address)."""
    script = tmp_path / "host.py"
    script.write_text(textwrap.dedent(f"""\
        import ray_tpu_torch
        from ray_tpu_torch.util.client import start_client_server
        ray_tpu_torch.init(num_cpus={num_cpus}, device="cpu")
        start_client_server(port=0, host="127.0.0.1")
        """))
    proc = subprocess.Popen([sys.executable, str(script)], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline().decode()
        if "listening on" in line:
            return proc, "ray-tpu://" + line.strip().rsplit(" ", 1)[1]
        if proc.poll() is not None:
            raise RuntimeError("client server died: "
                               + proc.stdout.read().decode()[-2000:])
    proc.kill()
    raise AssertionError("client server never came up")


def stop_host(proc):
    """SIGTERM ends the host's driver and, with it, its cluster."""
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def client_cluster(tmp_path_factory):
    ray_tpu_torch.shutdown()
    proc, address = start_host(tmp_path_factory.mktemp("client"))
    yield address
    stop_host(proc)


def test_client_tasks_objects_actors(client_cluster):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address=client_cluster)
    try:
        # objects
        ref = ray_tpu_torch.put({"hello": 42})
        assert ray_tpu_torch.get(ref, timeout=60)["hello"] == 42

        # tasks (including ref args crossing the proxy)
        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        r1 = add.remote(1, 2)
        r2 = add.remote(r1, ray_tpu_torch.put(10))
        assert ray_tpu_torch.get(r2, timeout=120) == 13

        # wait
        ready, pending = ray_tpu_torch.wait([r1, r2], num_returns=2,
                                            timeout=60)
        assert len(ready) == 2 and not pending

        # actors
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

        c = Counter.options(num_cpus=0.1).remote(100)
        assert ray_tpu_torch.get(c.incr.remote(), timeout=120) == 101
        assert ray_tpu_torch.get(c.incr.remote(5), timeout=60) == 106

        # errors propagate
        @ray_tpu_torch.remote
        def boom():
            raise ValueError("kaboom")

        with pytest.raises(Exception, match="kaboom"):
            ray_tpu_torch.get(boom.remote(), timeout=120)

        # cluster info
        assert ray_tpu_torch.cluster_resources().get("CPU") == 4.0
    finally:
        ray_tpu_torch.shutdown()


def test_request_resources_goes_through_the_proxy(client_cluster):
    """A client holds no GCS connection: ``request_resources`` reaches the
    GCS KV through the proxy's driver, where the autoscaler reads it."""
    from ray_tpu_torch.autoscaler import request_resources

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address=client_cluster)
    try:
        request_resources(num_cpus=3, bundles=[{"GPU": 1}])

        @ray_tpu_torch.remote
        def hints():
            from ray_tpu_torch._private import wire
            from ray_tpu_torch._private.worker import global_worker

            core = global_worker()
            reply = core._run(core._gcs_call("KVGet", {
                "ns": "autoscaler", "key": "request_resources"}))
            return wire.loads(reply["value"])

        assert ray_tpu_torch.get(hints.remote(), timeout=120) == [
            {"CPU": 3.0}, {"GPU": 1.0}]
        request_resources(bundles=[])
        assert ray_tpu_torch.get(hints.remote(), timeout=120) == []
    finally:
        ray_tpu_torch.shutdown()


MAIN_CLIENT = """\
import sys

import torch

import ray_tpu_torch


def scale(t, by):
    return t * by


class Accumulator:
    def __init__(self, start):
        self.total = torch.tensor(start)

    def add(self, t):
        self.total = self.total + t.sum()
        return self.total

    def where(self):
        import os

        return os.getpid()


ray_tpu_torch.init(address=sys.argv[1])
fn = ray_tpu_torch.remote(scale)
acc = ray_tpu_torch.remote(Accumulator).options(num_cpus=0.1).remote(1.5)
x = torch.arange(6, dtype=torch.float32)
y = ray_tpu_torch.get(fn.remote(x, 3.0), timeout=120)
assert torch.equal(y, x * 3.0), y
assert ray_tpu_torch.get(acc.add.remote(y), timeout=120).item() == 46.5
pid = ray_tpu_torch.get(acc.where.remote(), timeout=60)
assert pid != __import__("os").getpid()
ray_tpu_torch.shutdown()
print("MAIN_CLIENT_OK", pid)
"""


def test_main_module_function_and_class_run_by_value(client_cluster,
                                                     tmp_path):
    """A function and a class of a client's ``__main__`` cannot be imported
    on the cluster: they cross by value and run there."""
    script = tmp_path / "main_client.py"
    script.write_text(MAIN_CLIENT)
    out = subprocess.run([sys.executable, str(script), client_cluster],
                         env=_env(), capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MAIN_CLIENT_OK" in out.stdout
