"""Job submission: SDK + supervisor actors (reference: dashboard/modules/job).

``JobSubmissionClient.submit_job`` (reference: job/sdk.py:126) starts a
detached ``JobSupervisor`` actor (reference: job_supervisor.py) that runs
the entrypoint command as a subprocess wired to this cluster
(``RAY_TPU_TORCH_ADDRESS``), applies the job's runtime_env (env vars + extracted
working_dir as the subprocess cwd), captures combined output, and records
status + logs in GCS KV so any client can poll them. The dashboard-lite
HTTP server exposes the same operations over REST. The port of
``ray_tpu/job``.
"""

from ray_tpu_torch.job.job_manager import (
    JobStatus,
    JobSubmissionClient,
)

__all__ = ["JobSubmissionClient", "JobStatus"]
