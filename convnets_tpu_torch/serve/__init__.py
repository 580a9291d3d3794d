from convnets_tpu_torch.serve.serving import ServingModel, serving_forward  # noqa: F401
