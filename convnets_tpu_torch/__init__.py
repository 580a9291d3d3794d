"""convnets_tpu_torch — the PyTorch + CUDA port of convnets_tpu.

The JAX package `convnets_tpu` stays the reference; every module here
mirrors its counterpart's name and is tested against it on the CPU
(tests/test_torch_*.py). This package imports torch, never jax, and nothing
of convnets_tpu.

Ported so far: the serving and train paths of ten families (ResNet,
MobileNet-v1, DenseNet, ResNeXt, LeNet, ConvNet, the template net, VGG,
SqueezeNet, InceptionNet-v1), the Trainer with its host feed and the
device data path, the single-file serving artifact, the CLI with its
drivers, the tuner, data parallel over a mesh of processes, the Winograd
path and the native image codec.
  settings.py   run configuration (a copy of the JAX package's)
  core/      dtype policy, shape math, random-number streams
  ops/       plain tensor ops (NHWC), the CPU oracles of the kernels
  ops/kernels/  hand-written CUDA kernels (csrc/*.cu), their wrappers, and
             the eval path's kernels as torch custom ops (library.py)
  nn/        modules whose child names follow the JAX variable paths
  models/    Builder, Model, registry; the ten families
  data/      datasets, the seeded DataLoader, device_prefetch, the
             device-resident DeviceCacheLoader, DataMngr, augmentation
  serve/     ServingModel and the torch.export artifact (uint8 wire,
             baked normalization, symbolic batch)
  train/     train and eval steps, Trainer, optimizers, schedulers,
             metrics, checkpoints in the JAX package's format
  tune/      ParameterSampler and the random-search Tuner
  parallel/  the data-parallel DeviceMesh, sync-BN sums over its data group,
             init_distributed, dryrun_multichip
  viz/       plots (matplotlib, imported only where a driver plots) and
             the reference repo's published results table
  native/    the PNG/JPEG decode + resize codec (host C++, g++ at first use)
  bridge.py  JAX variables and optimizer state <-> port tensors, by path
  drivers.py process_fit / process_tune / process_load / process_export /
             process_eval; utils.py split, set_reproducible_mode,
             get_models_scores; __main__.py the CLI
"""

__version__ = "0.1.0"

from convnets_tpu_torch.settings import HyperParams, HyperParamsDistrib, Settings  # noqa: F401
