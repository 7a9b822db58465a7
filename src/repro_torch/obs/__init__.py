"""repro_torch.obs — metrics, span tracing and exposition (copies of
repro.obs.metrics, repro.obs.trace and repro.obs.export)."""

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
from repro_torch.obs.export import (
    ObsServer,
    prometheus_text,
    read_snapshot_file,
    write_snapshot,
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
    "ObsServer",
    "prometheus_text",
    "write_snapshot",
    "read_snapshot_file",
]
