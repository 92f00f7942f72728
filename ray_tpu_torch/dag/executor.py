"""Compiled-graph actor-side executor, the port of
``ray_tpu/dag/executor.py``.

Reference: python/ray/dag/dag_node_operation.py:704 — compilation emits a
STATIC per-actor schedule (ordered read/compute/write ops); each actor runs
its schedule in a loop over the channel data plane with no per-iteration
control-plane traffic. The driver only writes the input channel and reads
the output channel.

The schedule shipped to an actor:
  {"chan_readers": {chan_name: reader_slot},   # one slot per (actor, chan)
   "ops": [
     {"method": str,                 # method name on the actor instance
      "args": [("const", value) |   # literal argument
               ("chan", name) |     # this iteration's value of a channel
               ("chan_idx", (name, i)) |  # ...indexed (InputNode slots)
               ("local", op_index)],      # output of an earlier op here
      "out": Optional[str]}]}       # channel to write the result to

Every channel is read at most once per iteration per actor (values fan out
to all ops through the iteration cache), and every out-channel receives
exactly one value (result, error, or stop) per iteration — so downstream
readers observe every iteration in order.
"""

from __future__ import annotations

import logging
import threading
import traceback
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.channels import ChannelError, _Stop

logger = logging.getLogger("ray_tpu_torch.dag")

DAG_LOOP_METHOD = "__rtpu_dag_loop__"


class DagLoopRunner:
    """Runs one actor's static schedule until a STOP sentinel arrives."""

    def __init__(self, instance: Any, schedule: dict):
        from ray_tpu_torch.dag.channels import open_reader, open_writer

        self.instance = instance
        self.ops: List[dict] = schedule["ops"]
        specs = schedule.get("chan_specs") or {}
        self._read_chans: Dict[str, Any] = {}
        self._write_chans: Dict[str, Any] = {}
        for name, slot in (schedule.get("chan_readers") or {}).items():
            self._read_chans[name] = open_reader(name, slot, specs.get(name))
        for op in self.ops:
            if op.get("out"):
                self._write_chans[op["out"]] = open_writer(
                    op["out"], specs.get(op["out"]))
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="rtpu-dag-loop", daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while self._run_one_iteration():
                pass
        except Exception:
            logger.exception("dag loop crashed")

    def _run_one_iteration(self) -> bool:
        chan_cache: Dict[str, Any] = {}
        locals_: Dict[int, Any] = {}
        saw_stop = False

        def chan_value(name):
            if name not in chan_cache:
                chan_cache[name] = self._read_chans[name].read()
            return chan_cache[name]

        for idx, op in enumerate(self.ops):
            args = []
            sentinel = None  # _Stop or ChannelError poisoning this op
            for kind, v in op["args"]:
                if kind == "const":
                    value = v
                elif kind == "chan":
                    value = chan_value(v)
                elif kind == "chan_idx":
                    value = chan_value(v[0])
                    if not isinstance(value, (_Stop, ChannelError)):
                        value = value[v[1]]
                else:  # local
                    value = locals_[v]
                if isinstance(value, _Stop):
                    sentinel = value  # teardown wins over error propagation
                    saw_stop = True
                elif isinstance(value, ChannelError):
                    sentinel = sentinel or value
                args.append(value)
            if sentinel is not None:
                result = sentinel
            else:
                try:
                    result = getattr(self.instance, op["method"])(*args)
                except Exception as e:
                    result = ChannelError(
                        f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
            locals_[idx] = result
            if op.get("out"):
                self._write_chans[op["out"]].write(result)
        return not saw_stop
