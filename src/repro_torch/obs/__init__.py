"""repro_torch.obs — metrics and span tracing (copies of repro.obs.metrics
and repro.obs.trace; the exposition layer is not ported yet)."""

from repro_torch.obs.metrics import (
    BUCKET_BOUNDS,
    Histogram,
    MetricsRegistry,
    get_registry,
    histogram_quantile,
    merge_snapshots,
    set_registry,
    summarize_histograms,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    Tracer,
    configure_tracer,
    export_chrome_trace,
    get_tracer,
    span,
    validate_trace,
)

__all__ = [
    "BUCKET_BOUNDS",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "histogram_quantile",
    "merge_snapshots",
    "summarize_histograms",
    "Tracer",
    "NULL_TRACER",
    "configure_tracer",
    "get_tracer",
    "span",
    "validate_trace",
    "export_chrome_trace",
]
