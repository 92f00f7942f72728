"""Per-process logging setup: files under <session>/logs plus stderr.

Reference: python/ray/_private/log_monitor.py + util/logging.cc (rotating
per-process log files under session_latest/logs).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys


def setup_process_logging(name: str, log_dir: str = "", level=logging.INFO):
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter(
        f"%(asctime)s {name} %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"
    )
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"{name}_{os.getpid()}.log"),
            maxBytes=64 * 1024 * 1024,
            backupCount=2,
        )
        fh.setFormatter(fmt)
        root.addHandler(fh)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    sh.setLevel(logging.WARNING)
    root.addHandler(sh)
