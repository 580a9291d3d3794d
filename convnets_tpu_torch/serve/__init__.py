from convnets_tpu_torch.serve.export import (  # noqa: F401
    ServingModel, export_model, export_trainer, load_artifact, read_artifact, save_artifact,
)
