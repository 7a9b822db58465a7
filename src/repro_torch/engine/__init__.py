"""repro_torch.engine — the unified campaign engine.

One abstraction, :class:`Campaign`, owns the ask/evaluate/tell loop that was
previously re-implemented by ``run_search``, the background tuner, the
autotune CLI, and the benchmark drivers. A campaign couples a
:class:`~repro_torch.core.search.BayesianSearch` (batched ``ask(n)`` with a
constant-liar fill-in) to a pluggable :class:`Executor` (inline,
thread-pool, or whatever a :class:`~repro_torch.dispatch.registry.VariantSpec`
injects — e.g. the roofline cost backend), checkpoints every record through
the :class:`~repro_torch.core.database.PerformanceDatabase` JSONL, and resumes a
killed campaign without re-evaluating completed configs.

    from repro_torch.engine import Campaign
    res = Campaign(space, evaluator, max_evals=100, parallel=4).run()
"""

from repro_torch.engine.campaign import Campaign
from repro_torch.engine.executors import (
    Executor,
    InlineExecutor,
    ThreadExecutor,
    evaluator_for_spec,
    make_executor,
)

__all__ = [
    "Campaign",
    "Executor",
    "InlineExecutor",
    "ThreadExecutor",
    "evaluator_for_spec",
    "make_executor",
]
