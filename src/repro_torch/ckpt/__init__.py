"""repro_torch.ckpt: checkpoints in the JAX package's on-disk layout."""
