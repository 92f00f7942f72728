"""Runtime envs and job submission on the port's runtime, on the CPU: a
mirror of ``tests/test_jobs_runtime_env.py`` (reference tier:
python/ray/tests/test_runtime_env*.py, dashboard/modules/job/tests); the
job's driver finds the cluster through ``RAY_TPU_TORCH_ADDRESS``."""

import os
import sys
import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_runtime_env_env_vars(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_RENV_FLAG": "hello42"}})
    def read_env():
        import os

        return os.environ.get("MY_RENV_FLAG")

    assert ray_tpu_torch.get(read_env.remote(), timeout=120) == "hello42"

    @ray_tpu_torch.remote
    def read_plain():
        import os

        return os.environ.get("MY_RENV_FLAG")

    # workers are keyed by env hash: a no-env task must NOT see the var
    assert ray_tpu_torch.get(read_plain.remote(), timeout=120) is None


def test_runtime_env_working_dir(cluster, tmp_path):
    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "my_renv_module.py").write_text("VALUE = 'from-working-dir'\n")
    (pkg / "data.txt").write_text("payload\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(pkg)})
    def use_pkg():
        import os

        import my_renv_module

        return my_renv_module.VALUE, os.path.exists("data.txt")

    value, has_file = ray_tpu_torch.get(use_pkg.remote(), timeout=120)
    assert value == "from-working-dir"
    assert has_file  # cwd is the extracted working_dir


def test_runtime_env_actor(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_RENV": "yes"}})
    class EnvActor:
        def read(self):
            import os

            return os.environ.get("ACTOR_RENV")

    a = EnvActor.remote()
    assert ray_tpu_torch.get(a.read.remote(), timeout=120) == "yes"
    ray_tpu_torch.kill(a)


def test_runtime_env_unsupported_field(cluster):
    with pytest.raises(ValueError, match="not supported"):
        @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["requests"]}})
        def f():
            return 1

        f.remote()


def test_job_submission_end_to_end(cluster, tmp_path):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    script = tmp_path / "workdir" / "job_script.py"
    script.parent.mkdir()
    script.write_text(
        "import os, sys\n"
        "print('job says hi', os.environ.get('JOBVAR'))\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init(log_to_driver=False)\n"
        "@ray_tpu_torch.remote\n"
        "def sq(x):\n"
        "    return x * x\n"
        "print('answer', ray_tpu_torch.get(sq.remote(7), timeout=120))\n"
    )
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} job_script.py",
        runtime_env={"working_dir": str(script.parent),
                     "env_vars": {"JOBVAR": "jv1",
                                  "JAX_PLATFORMS": "cpu"}})
    status = client.wait_until_finished(sid, timeout=240)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs
    assert "job says hi jv1" in logs
    assert "answer 49" in logs
    assert any(j["submission_id"] == sid for j in client.list_jobs())


def test_job_failure_and_stop(cluster):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert client.wait_until_finished(sid, timeout=120) == JobStatus.FAILED
    assert client.get_job_info(sid)["exit_code"] == 3

    sid2 = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
    deadline = time.time() + 60
    while client.get_job_status(sid2) == JobStatus.PENDING:
        assert time.time() < deadline
        time.sleep(0.2)
    assert client.stop_job(sid2)
    assert client.wait_until_finished(sid2, timeout=60) == JobStatus.STOPPED
    # terminal jobs can be deleted
    assert client.delete_job(sid)
    with pytest.raises(ValueError):
        client.get_job_status(sid)
