"""Worker provisioning plane: zygote prefork pool + warm-worker adoption.

Reference: ``src/ray/raylet/worker_pool.h`` (prestart + adoption semantics
behind ``RequestWorkerLease``) and Android's zygote process model. A
per-raylet zygote boots once, pre-imports the heavy stack, then forks ready
workers on demand over a control pipe; the raylet adopts a warm registered
worker on lease grant instead of paying a cold ``Popen`` interpreter+import
start-up. Cold spawn remains the fallback for pip/uv runtime envs (which
need a different interpreter), zygote death, and platforms without fork.
"""

from ray_tpu_torch._private.provisioner.pool import (  # noqa: F401
    ForkedProc,
    WorkerProvisioner,
    fork_supported,
)
