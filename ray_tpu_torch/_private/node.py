"""Node supervisor: starts/monitors the GCS and raylet processes.

Reference: python/ray/_private/node.py (``Node`` at :52) and services.py
process launchers (``start_gcs_server`` :1434, ``start_raylet`` :1518).
The port of ``ray_tpu/_private/node.py``: its processes run the port's
modules, and its sessions live under ``torch_session_root``
(``<tmp>/ray_tpu_torch_sessions/session_*``, newest at ``session_latest``),
apart from the JAX runtime's.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import RAY_CONFIG

logger = logging.getLogger("ray_tpu_torch.node")


def _wait_for_file(path: str, timeout: float = 30.0,
                   proc: Optional[subprocess.Popen] = None,
                   what: str = "service") -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                content = f.read().strip()
            if content:
                return content
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"{what} exited with code {proc.returncode} before becoming "
                f"ready (see its log under the session logs directory)")
        time.sleep(0.02)
    raise TimeoutError(f"{what} did not write {path} in {timeout}s")


def new_session_dir() -> str:
    root = RAY_CONFIG.torch_session_root
    session = os.path.join(root, f"session_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    latest = os.path.join(root, "session_latest")
    try:
        if os.path.islink(latest):
            os.unlink(latest)
        os.symlink(session, latest)
    except OSError:  # raylint: disable=EXC001 session_latest symlink is a convenience; racing starters may lose
        pass
    return session


class NodeSupervisor:
    """Launches a head node: GCS + one raylet (plus extra raylets for tests)."""

    def __init__(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        gcs_fault_tolerance: bool = False,
    ):
        self.resources = resources or {}
        self.labels = labels or {}
        self.object_store_memory = object_store_memory
        self.session_dir = new_session_dir()
        self.log_dir = os.path.join(self.session_dir, "logs")
        self.processes: List[subprocess.Popen] = []
        self.gcs_address: Optional[str] = None
        self.gcs_fault_tolerance = gcs_fault_tolerance
        self.gcs_persist_dir = (
            os.path.join(self.session_dir, "gcs_store") if gcs_fault_tolerance else "")
        self.gcs_proc: Optional[subprocess.Popen] = None

    def _launch_gcs(self, port: int = 0) -> str:
        gcs_file = os.path.join(self.session_dir, f"gcs_address_{uuid.uuid4().hex[:6]}")
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.gcs",
               "--address-file", gcs_file, "--log-dir", self.log_dir]
        if port:
            cmd += ["--port", str(port)]
        if self.gcs_persist_dir:
            cmd += ["--persist-dir", self.gcs_persist_dir]
        self.gcs_proc = subprocess.Popen(
            cmd, stdout=self._log("gcs_out"), stderr=subprocess.STDOUT,
            env=self._child_env(),
        )
        self.processes.append(self.gcs_proc)
        return _wait_for_file(gcs_file)

    def start_head(self) -> str:
        self.gcs_address = self._launch_gcs()
        self.start_raylet(self.resources, self.labels, is_head=True)
        return self.gcs_address

    def start_dashboard(self, host: str = "127.0.0.1",
                        port: Optional[int] = None) -> str:
        """Launch the dashboard-lite head HTTP server (reference:
        dashboard/head.py started by services.py on the head node)."""
        assert self.gcs_address
        addr_file = os.path.join(self.session_dir, "dashboard_address")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.dashboard.head",
             "--gcs-address", self.gcs_address,
             "--host", host, "--port", str(port or 0),
             "--log-dir", self.log_dir,
             "--address-file", addr_file],
            stdout=self._log("dashboard_out"), stderr=subprocess.STDOUT,
            env=self._child_env(),
        )
        self.processes.append(proc)
        self.dashboard_address = _wait_for_file(addr_file, proc=proc,
                                                what="dashboard")
        return self.dashboard_address

    def kill_gcs(self):
        """Hard-kill the GCS process (fault-injection for FT tests)."""
        assert self.gcs_proc is not None
        self.gcs_proc.kill()
        self.gcs_proc.wait(timeout=10)
        self.processes.remove(self.gcs_proc)

    def restart_gcs(self) -> str:
        """Relaunch the GCS on the SAME address with the persisted tables
        (reference: GCS FT via Redis-backed store + GcsInitData replay)."""
        assert self.gcs_address and self.gcs_persist_dir, \
            "restart_gcs requires gcs_fault_tolerance=True"
        port = int(self.gcs_address.rsplit(":", 1)[1])
        addr = self._launch_gcs(port=port)
        assert addr == self.gcs_address, (addr, self.gcs_address)
        return addr

    def start_raylet(self, resources=None, labels=None, is_head=False,
                     object_store_memory=None) -> str:
        assert self.gcs_address
        addr_file = os.path.join(self.session_dir, f"raylet_{uuid.uuid4().hex[:8]}")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet",
            "--gcs-address", self.gcs_address,
            "--resources", json.dumps(resources or {}),
            "--labels", json.dumps(labels or {}),
            "--log-dir", self.log_dir,
            "--address-file", addr_file,
        ]
        if is_head:
            cmd.append("--head")
        osm = object_store_memory or self.object_store_memory
        if osm:
            cmd += ["--object-store-memory", str(int(osm))]
        proc = subprocess.Popen(cmd, stdout=self._log("raylet_out"),
                                stderr=subprocess.STDOUT,
                                env=self._child_env())
        self.processes.append(proc)
        return _wait_for_file(addr_file, timeout=60.0)

    def _child_env(self):
        return dict(os.environ, RAY_TPU_PARENT_PID=str(os.getpid()))

    def _log(self, name: str):
        return open(os.path.join(self.log_dir, f"{name}.log"), "ab")

    def stop(self):
        for proc in reversed(self.processes):
            try:
                proc.terminate()
            except Exception as e:
                logger.debug("terminate of pid %s failed: %s", proc.pid, e)
        deadline = time.monotonic() + 3.0
        for proc in self.processes:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    proc.kill()
                except Exception as e:
                    logger.debug("kill of pid %s failed: %s", proc.pid, e)
        self.processes.clear()
