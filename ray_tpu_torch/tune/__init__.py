"""ray_tpu_torch.tune: hyperparameter search (reference: ray.tune), the
port of ``ray_tpu/tune``: the same searchers, schedulers and ``Tuner``,
whose trials run on the port's runtime and ask for cards as ``"GPU"``."""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.searchers import (
    BasicVariantSearcher,
    QuasiRandomSearcher,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.search import choice, grid_search, loguniform, randint, uniform
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TrialResult,
    TuneConfig,
    Tuner,
    TuneStopException,
    report,
)

__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "TrialResult",
    "TuneStopException",
    "report",
    "grid_search",
    "choice",
    "uniform",
    "loguniform",
    "randint",
    "ASHAScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher",
    "BasicVariantSearcher",
    "QuasiRandomSearcher",
    "TPESearcher",
    "FIFOScheduler",
]
