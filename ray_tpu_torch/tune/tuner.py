"""Tuner: hyperparameter sweeps over trial actors.

Reference: python/ray/tune/tuner.py + execution/tune_controller.py — trials
run as resource-requesting actors; intermediate ``tune.report`` results flow
through a report hub actor; the scheduler (e.g. ASHA) stops losers early by
failing their next report with ``TuneStopException``.

The port of ``ray_tpu/tune/tuner.py``: the trainable and the scheduler
travel through the port's by-value pickler (no cloudpickle), a trial asks
for cards as ``"GPU"`` in ``resources_per_trial`` (``num_gpus``), PBT's
checkpoints go through the port's checkpoint plane, and the default trial
store lives under the temporary directory.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP

_session = threading.local()


class TuneStopException(Exception):
    """Raised inside a trial when the scheduler stops it early."""


class TuneExploitException(Exception):
    """Raised inside a trial when PBT replaces it with a better trial's
    checkpoint + perturbed config; the tuner restarts the trial."""

    def __init__(self, config, checkpoint):
        super().__init__("pbt exploit")
        self.config = config
        self.checkpoint = checkpoint


@dataclass
class TuneConfig:
    metric: str = "score"
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_alg: Any = None  # a tune.searchers.Searcher proposing configs
    seed: int = 0
    # checkpoint-plane store root for trial checkpoints (PBT exploit state);
    # default: a run-scoped dir under the temporary directory, deleted
    # when fit() returns.
    # On a multi-node cluster this MUST be a path shared by every trial
    # node (NFS/gcsfuse) — the same contract as RunConfig.storage_path
    storage_path: Optional[str] = None


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    error: Optional[str] = None
    stopped_early: bool = False


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self.results = results
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        ok = [r for r in self.results if r.error is None and metric in r.metrics]
        if not ok:
            raise ValueError("no successful trials with the requested metric")
        sign = 1 if mode == "max" else -1
        return max(ok, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        """One row a trial (metrics, ``config/<key>`` columns, trial id,
        error); needs pandas, and raises ImportError naming it without."""
        from ray_tpu_torch.data.block import _pandas

        pd = _pandas("ResultGrid.get_dataframe")
        return pd.DataFrame([
            {**r.metrics, **{f"config/{k}": v for k, v in r.config.items()},
             "trial_id": r.trial_id, "error": r.error}
            for r in self.results
        ])

    def __len__(self):
        return len(self.results)


@ray_tpu_torch.remote(num_cpus=0.1)
class _ReportHub:
    """Collects trial reports and runs scheduler decisions centrally."""

    def __init__(self, scheduler_blob: bytes):
        # driver-authored blob: decode only through the audited
        # serialization boundary (raylint SER001)
        from ray_tpu_torch._private.serialization import loads_trusted

        self.scheduler = loads_trusted(scheduler_blob)
        self.latest: Dict[str, Dict] = {}
        self.iters: Dict[str, int] = {}
        self.registered: set = set()
        self.finished: set = set()
        # report() runs on the actor's thread pool (max_concurrency > 1);
        # schedulers iterate shared dicts, so serialize their callbacks.
        # The condition variable implements synchronized-PBT rendezvous.
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def register_trial(self, trial_id: str, config: Dict):
        # PBT needs trial configs for exploit mutation
        with self._cv:
            self.registered.add(trial_id)
            self.finished.discard(trial_id)  # exploit relaunch
            hook = getattr(self.scheduler, "register_trial", None)
            if hook is not None:
                hook(trial_id, config)
            self._cv.notify_all()
        return True

    def finish_trial(self, trial_id: str):
        """A trial completed or errored: release any rendezvous waiters."""
        with self._cv:
            self.finished.add(trial_id)
            self._cv.notify_all()
        return True

    def report(self, trial_id: str, metrics: Dict, checkpoint=None):
        with self._cv:
            self.iters[trial_id] = self.iters.get(trial_id, 0) + 1
            t = self.iters[trial_id]
            metrics = dict(metrics)
            metrics.setdefault("training_iteration", t)
            self.latest[trial_id] = metrics
            if checkpoint is not None:
                hook = getattr(self.scheduler, "record_checkpoint", None)
                if hook is not None:
                    hook(trial_id, checkpoint)
            sync_t = getattr(self.scheduler, "synch_interval", None)
            if sync_t and t % sync_t == 0:
                # synchronized PBT: wait until every live trial reached this
                # boundary (or finished) so the decision sees the whole
                # population. Bounded: a crashed trial, or one whose worker
                # cannot schedule (num_samples > max_concurrent_trials on a
                # saturated cluster), degrades to a partial-population
                # decision after the timeout instead of wedging the run.
                def _ready():
                    return all(self.iters.get(tid, 0) >= t
                               or tid in self.finished
                               for tid in self.registered)

                self._cv.notify_all()
                self._cv.wait_for(_ready, timeout=30.0)
            return self.scheduler.on_result(trial_id, metrics)

    # NOTE: exploited trials do NOT reset their iteration counter — the
    # count is total iterations executed by the trial slot, so perturbation
    # boundaries (t % interval) stay aligned across the population and the
    # synch rendezvous is not desynchronized by a routine exploit.

    def get_latest(self):
        return dict(self.latest)


@ray_tpu_torch.remote
def _run_trial(fn_blob: bytes, config, trial_id: str, hub,
               ckpt_root=None) -> Dict:
    # runtime imports: the decorated function pickles by value, so it must not
    # close over module globals (the thread-local session is unpicklable;
    # the port's pickler also takes a global that an attribute of the same
    # name reads, so the session is set through a function)
    from ray_tpu_torch._private.serialization import loads_trusted

    from ray_tpu_torch.tune import tuner as _tuner

    # driver-authored trainable blob: audited boundary only (raylint SER001)
    fn = loads_trusted(fn_blob)
    _tuner._enter_trial(hub, trial_id, ckpt_root)
    config = _tuner._resolve_checkpoint_ref(config)
    try:
        out = fn(config)
        return {"metrics": out if isinstance(out, dict) else {}, "stopped": False}
    except _tuner.TuneStopException:
        return {"metrics": {}, "stopped": True}
    except _tuner.TuneExploitException as e:
        return {"metrics": {}, "exploit": {"config": e.config,
                                           "checkpoint": e.checkpoint}}
    finally:
        _tuner._enter_trial(None, trial_id, ckpt_root)


def _enter_trial(hub, trial_id: str, ckpt_root) -> None:
    """Bind this thread's ``report`` to a trial (``hub`` None unbinds)."""
    _session.hub = hub
    _session.trial_id = trial_id
    _session.ckpt_root = ckpt_root


def _resolve_checkpoint_ref(config):
    """Rehydrate a checkpoint-plane ref in ``config["__checkpoint__"]``
    (the shape PBT exploit hands around) back into the tree the trainable
    expects. Plain checkpoint values pass through untouched."""
    ref = (config or {}).get("__checkpoint__")
    if not (isinstance(ref, dict) and "__ckpt_ref__" in ref):
        return config
    from ray_tpu_torch.ckpt import CheckpointStore, restore_tree

    config = dict(config)
    try:
        config["__checkpoint__"] = restore_tree(
            CheckpointStore(ref["root"]), ref["__ckpt_ref__"], timeout=5.0)
    except (TimeoutError, FileNotFoundError) as e:
        raise RuntimeError(
            f"trial checkpoint {ref['__ckpt_ref__']!r} is not readable "
            f"from this node (store root {ref['root']!r}). PBT exploit "
            f"state lives on the checkpoint plane; on a multi-node "
            f"cluster set TuneConfig.storage_path to a path shared by "
            f"every trial node (NFS/gcsfuse), like RunConfig.storage_path "
            f"for train runs") from e
    return config


_trial_savers: Dict[str, Any] = {}  # store root -> per-process saver


def _save_trial_checkpoint(checkpoint):
    """Route a trial's reported checkpoint through the checkpoint plane:
    the tree is committed to the run's store and only a tiny manifest ref
    crosses to the hub — PBT exploit then is a manifest swap, and the
    donor state is never re-pickled through hub -> tuner -> trial.
    Content addressing dedups the unchanged leaves across a trial's
    consecutive reports and across cloned trials (the store root must be
    shared across trial nodes; see TuneConfig.storage_path)."""
    root = getattr(_session, "ckpt_root", None)
    if root is None or checkpoint is None or (
            isinstance(checkpoint, dict) and "__ckpt_ref__" in checkpoint):
        return checkpoint
    from ray_tpu_torch.ckpt import CheckpointSaver, CheckpointStore

    saver = _trial_savers.get(root)
    if saver is None:
        saver = _trial_savers[root] = CheckpointSaver(CheckpointStore(root))
    # blocking: the ref may be exploited by another trial the moment the
    # hub sees it, so the manifest must be committed before it escapes
    cid = saver.save(checkpoint, blocking=True)
    return {"__ckpt_ref__": cid, "root": root}


def report(metrics: Dict[str, Any], checkpoint=None):
    """tune.report inside a trial. Raises TuneStopException when the
    scheduler stops the trial, TuneExploitException when PBT replaces it
    with a better trial's state. Checkpoints are saved to the run's
    checkpoint-plane store trial-side; the hub only ever sees manifest
    refs."""
    hub = getattr(_session, "hub", None)
    if hub is None:
        raise RuntimeError("tune.report called outside a trial")
    checkpoint = _save_trial_checkpoint(checkpoint)
    decision = ray_tpu_torch.get(
        hub.report.remote(_session.trial_id, metrics, checkpoint), timeout=300)
    if decision == STOP:
        raise TuneStopException()
    if isinstance(decision, (tuple, list)) and decision and decision[0] == "EXPLOIT":
        payload = decision[1]
        raise TuneExploitException(payload["config"], payload["checkpoint"])


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Dict[str, Any],
                 tune_config: Optional[TuneConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None):
        self.trainable = trainable
        self.param_space = param_space
        self.tune_config = tune_config or TuneConfig()
        self.resources = resources_per_trial or {"CPU": 1.0}

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        searcher = tc.search_alg
        if searcher is None:
            from ray_tpu_torch.tune.searchers import BasicVariantSearcher

            searcher = BasicVariantSearcher(self.param_space, tc.num_samples,
                                            tc.seed)
        run_tag = uuid.uuid4().hex[:8]
        from ray_tpu_torch._private.serialization import dumps

        hub = _ReportHub.options(
            # every RUNNING trial may hold one hub thread at a synch
            # rendezvous; size the pool so waiters can never starve the
            # report() that would release them
            name=f"tune_hub_{run_tag}",
            max_concurrency=max(16, tc.max_concurrent_trials + 4),
        ).remote(dumps(scheduler))
        fn_blob = dumps(self.trainable)
        # trial checkpoints live on the checkpoint plane for the run's
        # lifetime; an ephemeral (default) root is deleted on completion
        ckpt_root = tc.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "tune_ckpts",
            f"run_{run_tag}")
        ephemeral_store = tc.storage_path is None

        pending: List[tuple] = []
        running: Dict[Any, tuple] = {}
        results: List[TrialResult] = []
        trial_seq = 0
        exhausted = False

        def launch(trial_id, cfg):
            ray_tpu_torch.get(hub.register_trial.remote(trial_id, cfg), timeout=60)
            ref = _run_trial.options(
                num_cpus=self.resources.get("CPU", 1.0),
                num_gpus=self.resources.get("GPU", 0.0),
                resources={k: v for k, v in self.resources.items()
                           if k not in ("CPU", "GPU")},
            ).remote(fn_blob, cfg, trial_id, hub, ckpt_root)
            running[ref] = (trial_id, cfg)

        while True:
            # refill from exploit-requeues first, then the searcher
            while pending and len(running) < tc.max_concurrent_trials:
                launch(*pending.pop(0))
            while not exhausted and len(running) < tc.max_concurrent_trials:
                trial_id = f"trial_{trial_seq:05d}"
                cfg = searcher.suggest(trial_id)
                if cfg is None:
                    exhausted = True
                    break
                trial_seq += 1
                launch(trial_id, cfg)
            if not running and not pending and exhausted:
                break
            ready, _ = ray_tpu_torch.wait(list(running.keys()), num_returns=1,
                                    timeout=1.0)
            for ref in ready:
                trial_id, cfg = running.pop(ref)
                latest = ray_tpu_torch.get(hub.get_latest.remote(), timeout=60).get(
                    trial_id, {})
                try:
                    out = ray_tpu_torch.get(ref, timeout=60)
                except TaskError as e:
                    ray_tpu_torch.get(hub.finish_trial.remote(trial_id), timeout=60)
                    cfg_clean = {k: v for k, v in cfg.items()
                                 if k != "__checkpoint__"}
                    results.append(TrialResult(trial_id, cfg_clean, latest,
                                               error=str(e)[:500]))
                    searcher.on_trial_complete(
                        trial_id, {**latest, "__config__": cfg_clean})
                    continue
                exploit = out.get("exploit")
                if exploit is not None:
                    # PBT: restart this trial from the donor's checkpoint
                    # with the perturbed config
                    new_cfg = dict(exploit["config"])
                    new_cfg["__checkpoint__"] = exploit["checkpoint"]
                    pending.append((trial_id, new_cfg))
                    continue
                ray_tpu_torch.get(hub.finish_trial.remote(trial_id), timeout=60)
                final = dict(latest)
                final.update(out.get("metrics") or {})
                cfg_clean = {k: v for k, v in cfg.items()
                             if k != "__checkpoint__"}
                results.append(TrialResult(trial_id, cfg_clean, final,
                                           stopped_early=out.get("stopped",
                                                                 False)))
                searcher.on_trial_complete(
                    trial_id, {**final, "__config__": cfg_clean})
        ray_tpu_torch.kill(hub)
        if ephemeral_store:
            import shutil

            shutil.rmtree(ckpt_root, ignore_errors=True)
        return ResultGrid(results, tc.metric, tc.mode)
