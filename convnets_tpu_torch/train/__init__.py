from convnets_tpu_torch.train.checkpoint import load_jax_checkpoint  # noqa: F401
