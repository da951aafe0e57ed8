"""repro_torch.ft: a copy of the JAX package's fault tolerance helpers."""
