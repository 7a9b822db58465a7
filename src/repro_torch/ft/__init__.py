"""repro_torch.ft — fault tolerance: gradient compression (error feedback),
elastic mesh planning, straggler monitoring (the counterpart of
``repro.ft``). Evaluation-campaign fault tolerance (penalty-on-failure,
deadline) lives in repro_torch.core.plopper; search resume lives in
repro_torch.core.database."""

from repro_torch.ft.compression import compressed_psum, dequantize, ef_compress_grads, quantize
from repro_torch.ft.elastic import LADDER, MeshPlan, plan_mesh
from repro_torch.ft.straggler import StragglerMonitor

__all__ = ["compressed_psum", "dequantize", "ef_compress_grads", "quantize",
           "LADDER", "MeshPlan", "plan_mesh", "StragglerMonitor"]
