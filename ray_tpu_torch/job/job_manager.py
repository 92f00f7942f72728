"""Job manager: supervisor actor per job + KV-backed status/log store.

Reference: dashboard/modules/job/{job_manager.py,job_supervisor.py,sdk.py}.
KV schema (GCS): ns="job" key=<submission_id> -> wire-encoded info dict;
ns="job_logs" key=<submission_id> -> utf-8 log bytes (flushed periodically
and at exit by the supervisor).

The port of ``ray_tpu/job/job_manager.py``: the entrypoint finds its
cluster through ``RAY_TPU_TORCH_ADDRESS`` (the JAX runtime's is
``RAY_TPU_ADDRESS``), runtime environments go through the port's
``_private/runtime_env.py``, and the output file lives under the
temporary directory.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import wire


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _kv_call(method: str, req: dict):
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    return core._run(core._gcs_call(method, req))


def _job_put(submission_id: str, info: dict):
    _kv_call("KVPut", {"ns": "job", "key": submission_id,
                       "value": wire.dumps(info)})


def _job_get(submission_id: str) -> Optional[dict]:
    blob = _kv_call("KVGet", {"ns": "job", "key": submission_id})["value"]
    return wire.loads(blob) if blob is not None else None


@ray_tpu_torch.remote(num_cpus=0.1, max_restarts=0)
class JobSupervisor:
    """Runs one job entrypoint as a subprocess; owns its lifecycle."""

    def __init__(self, submission_id: str, entrypoint: str,
                 runtime_env: Optional[dict], metadata: Optional[dict]):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env
        self.metadata = metadata or {}
        self.proc: Optional[subprocess.Popen] = None
        self._stopped = False

    def _update(self, **fields):
        info = _job_get(self.submission_id) or {}
        info.update(fields)
        _job_put(self.submission_id, info)

    def _flush_logs(self, path: str):
        try:
            with open(path, "rb") as f:
                _kv_call("KVPut", {"ns": "job_logs", "key": self.submission_id,
                                   "value": f.read()})
        except FileNotFoundError:
            pass

    def run(self) -> str:
        """Blocking: runs the entrypoint to completion; returns final state."""
        from ray_tpu_torch._private import runtime_env as renv_mod
        from ray_tpu_torch._private.worker import global_worker

        core = global_worker()
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = core.gcs_address
        env["RAY_TPU_TORCH_JOB_SUBMISSION_ID"] = self.submission_id
        # the entrypoint must be able to import this framework even after
        # chdir into its working_dir (reference: ray injects itself)
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
            _pkg.__file__)))
        extra_paths = [pkg_root]
        cwd = None
        renv = self.runtime_env
        if renv:
            env.update(renv.get("env_vars") or {})

            def kv_get(key):
                return _kv_call("KVGet", {"ns": "renv", "key": key})["value"]

            wd = renv.get("working_dir")
            if wd:
                cwd = renv_mod._extract(wd, kv_get)
            extra_paths = [renv_mod._extract(p, kv_get)
                           for p in renv.get("py_modules") or []] + extra_paths
            if cwd:
                extra_paths.insert(0, cwd)
        env["PYTHONPATH"] = ":".join(
            extra_paths + [env.get("PYTHONPATH", "")]).rstrip(":")

        log_path = os.path.join(tempfile.gettempdir(),
                                f"ray_tpu_torch_job_{self.submission_id}.log")
        self._update(status=JobStatus.RUNNING, start_time=time.time())
        with open(log_path, "wb") as logf:
            self.proc = subprocess.Popen(
                self.entrypoint, shell=True, cwd=cwd, env=env,
                stdout=logf, stderr=subprocess.STDOUT)
            last_flush = 0.0
            while self.proc.poll() is None:
                time.sleep(0.2)
                if time.monotonic() - last_flush > 2.0:
                    self._flush_logs(log_path)
                    last_flush = time.monotonic()
        self._flush_logs(log_path)
        code = self.proc.returncode
        if self._stopped:
            state = JobStatus.STOPPED
        elif code == 0:
            state = JobStatus.SUCCEEDED
        else:
            state = JobStatus.FAILED
        self._update(status=state, end_time=time.time(), exit_code=code,
                     message=f"exit code {code}")
        return state

    def stop(self) -> bool:
        self._stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            return True
        return False

    def ping(self) -> bool:
        return True


class JobSubmissionClient:
    """SDK entry point (reference: dashboard/modules/job/sdk.py:36).

    Talks to the cluster through the driver's GCS connection; ``address``
    may be a GCS address or None to use the already-initialized driver /
    RAY_TPU_TORCH_ADDRESS.
    """

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, log_to_driver=False,
                         ignore_reinit_error=True)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        from ray_tpu_torch._private.worker import global_worker

        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if _job_get(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        core = global_worker()
        prepared = core._run(core._prepare_runtime_env(runtime_env)) \
            if runtime_env else None
        _job_put(submission_id, {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": JobStatus.PENDING,
            "submit_time": time.time(),
            "metadata": metadata or {},
        })
        # max_concurrency > 1: run() blocks for the whole job, stop()/ping()
        # must still get through (reference: async JobSupervisor)
        supervisor = JobSupervisor.options(
            name=f"_job_supervisor:{submission_id}", lifetime="detached",
            num_cpus=0.1, max_concurrency=4,
        ).remote(submission_id, entrypoint, prepared, metadata)
        supervisor.run.remote()  # fire-and-forget; status lands in KV
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        info = _job_get(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info["status"]

    def get_job_info(self, submission_id: str) -> dict:
        info = _job_get(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info

    def list_jobs(self) -> List[dict]:
        keys = _kv_call("KVKeys", {"ns": "job", "prefix": ""})["keys"]
        return [i for i in (_job_get(k) for k in keys) if i is not None]

    def get_job_logs(self, submission_id: str) -> str:
        blob = _kv_call("KVGet", {"ns": "job_logs",
                                  "key": submission_id})["value"]
        return (blob or b"").decode(errors="replace")

    def stop_job(self, submission_id: str) -> bool:
        try:
            sup = ray_tpu_torch.get_actor(f"_job_supervisor:{submission_id}")
        except ValueError:
            return False
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def delete_job(self, submission_id: str) -> bool:
        info = _job_get(submission_id)
        if info is None:
            return False
        if info["status"] not in JobStatus.TERMINAL:
            raise RuntimeError("job is still running; stop it first")
        _kv_call("KVDel", {"ns": "job", "key": submission_id})
        _kv_call("KVDel", {"ns": "job_logs", "key": submission_id})
        return True

    def wait_until_finished(self, submission_id: str, timeout: float = 300.0,
                            poll_s: float = 0.5) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")
