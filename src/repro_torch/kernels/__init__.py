"""repro_torch.kernels — the ported PolyBench kernels, hand-written in CUDA
for Hopper (``csrc/``), each beside its plain PyTorch version.

The paper's six benchmarks: syr2k (``syr2k.cu``), mm3 and lu's trailing
update (``matmul.cu``), covariance (``covariance.cu``), floyd_warshall (the
min-plus product and the single-block in-block closure,
``floyd_warshall.cu``), heat3d (the stencil pass, ``heat3d.cu``) and lu's
diagonal-block factor (a single-block helper, ``lu.cu``). The lu panel
solves are ``torch.linalg.solve_triangular``, plain array code in the JAX
package too.

Layout per kernel, as in ``repro.kernels``: <name>.py holds the wrapper (the
CUDA launch for tensors on the card, the plain version for tensors on the
CPU); ops.py the config-merging entry points; ref.py the oracles and the
numpy problem data; spaces.py the autotuner spaces; problems.py the problem
sizes and the variant factory; build.py the nvcc build and ctypes binding.
"""
