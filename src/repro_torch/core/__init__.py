"""repro_torch.core — the paper's contribution: a Bayesian-optimization
autotuner (copied from repro.core) with a CUDA-event timing evaluator."""

from repro_torch.core.acquisition import expected_improvement, lcb, make_acquisition
from repro_torch.core.database import PerformanceDatabase, Record
from repro_torch.core.findmin import find_min, importance_report
from repro_torch.core.plopper import (
    PENALTY,
    ConfigRejected,
    DeadlineEvaluator,
    EvalResult,
    TimingEvaluator,
)
from repro_torch.core.search import BayesianSearch, SearchResult, run_search
from repro_torch.core.space import (
    Categorical,
    ConfigurationSpace,
    Constant,
    EqualsCondition,
    Float,
    ForbiddenClause,
    InCondition,
    Integer,
    Ordinal,
    config_key,
)
from repro_torch.core.surrogates import (
    LEARNERS,
    ExtraTrees,
    GaussianProcess,
    GradientBoostedTrees,
    RandomForest,
    RegressionTree,
    make_learner,
)
from repro_torch.core.tuner import autotune, compare_learners

__all__ = [
    "Categorical", "ConfigurationSpace", "Constant", "EqualsCondition", "Float",
    "ForbiddenClause", "InCondition", "Integer", "Ordinal", "config_key",
    "RegressionTree", "RandomForest", "ExtraTrees", "GradientBoostedTrees",
    "GaussianProcess", "make_learner", "LEARNERS",
    "lcb", "expected_improvement", "make_acquisition",
    "PerformanceDatabase", "Record",
    "EvalResult", "TimingEvaluator", "DeadlineEvaluator", "ConfigRejected", "PENALTY",
    "BayesianSearch", "SearchResult", "run_search",
    "autotune", "compare_learners", "find_min", "importance_report",
]
