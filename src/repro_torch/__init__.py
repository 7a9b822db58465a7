"""repro_torch: the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

Same subpackage layout and names as ``repro``. The Bayesian-optimization
core, the campaign engine and the observability layer are verbatim copies;
the evaluator, the kernels and the CLI are rewritten so that every
configuration the tuner proposes is a launch of a hand-written CUDA kernel,
timed with CUDA events. This package never imports ``jax`` or ``repro``.
"""

__version__ = "0.1.0"
