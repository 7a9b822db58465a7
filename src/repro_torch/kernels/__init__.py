"""repro_torch.kernels — the ported PolyBench kernels, hand-written in CUDA
for Hopper (``csrc/``), each beside its plain PyTorch version.

Layout per kernel, as in ``repro.kernels``: <name>.py holds the wrapper (the
CUDA launch for tensors on the card, the plain version for tensors on the
CPU); ops.py the config-merging entry points; ref.py the oracles and the
numpy problem data; spaces.py the autotuner spaces; problems.py the problem
sizes and the variant factory; build.py the nvcc build and ctypes binding.
"""
