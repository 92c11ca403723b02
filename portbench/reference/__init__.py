"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the measured program and take only the weights and inputs the
benchmark made."""
