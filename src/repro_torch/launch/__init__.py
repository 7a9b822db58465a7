"""repro_torch.launch — command-line entry points (autotune, serve, guard,
fidelity, train, obs)."""
