"""repro_torch.data: a copy of the JAX package's token pipeline (numpy only)."""
