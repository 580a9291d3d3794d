"""Configuration (counterpart of convnets_tpu/settings.py, copied whole:
the port imports nothing of the JAX package).

Keeps the reference's two-schema design (reference settings.py:14-319):

* ``HyperParams``    — named-field bag with ``show``/``load_values``/``to_dict``.
* ``HyperParamsDistrib`` — the random-search space: each field is a list of
  choices or a distribution object with ``.rvs(random_state)``; ``None``
  fields are auto-filled from ``DEF_*`` class attributes.
* ``Settings``       — concrete run configuration; ``None`` constructor args
  are auto-filled from ``DEF_*`` defaults via the same reflection trick
  (reference settings.py:294-299).

The fields are the JAX package's, so a checkpoint's settings meta has the
same keys in both packages. ``mesh_shape``/``data_axis`` are kept for that
reason; the port has no mesh yet (ROADMAP.md modules item 7), and
``mixed_precision`` selects the bf16 compute policy.
"""

from __future__ import annotations

import math
import numpy as np


class Uniform:
    """Uniform(loc, loc+scale) — drop-in for scipy.stats.uniform's rvs API."""

    def __init__(self, loc: float, scale: float):
        self.loc, self.scale = float(loc), float(scale)

    def rvs(self, random_state: np.random.RandomState):
        return float(random_state.uniform(self.loc, self.loc + self.scale))

    def __repr__(self):
        return f"Uniform({self.loc}, {self.loc + self.scale})"


class LogUniform:
    """Log-uniform over [low, high]."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def rvs(self, random_state: np.random.RandomState):
        return float(
            math.exp(random_state.uniform(math.log(self.low), math.log(self.high)))
        )

    def __repr__(self):
        return f"LogUniform({self.low}, {self.high})"


# The tunable hyper-parameter field names, in reference declaration order
# (reference settings.py:20-37).
HPARAM_FIELDS = (
    "batch_size",
    "batch_norm",
    "epochs",
    "learning_rate",
    "lr_factor",
    "lr_patience",
    "weight_decay",
    "dropout_rate",
    "loss_optim",
    "data_augment",
    "data_norm",
    "early_stop",
    "es_patience",
    "grad_clip_norm",
    "gc_max_norm",
    "grad_clip_value",
    "gc_value",
    "init_params",
)


class HyperParams:
    """Named-field hyper-parameter bag (reference settings.py:14-63)."""

    def __init__(self):
        for name in HPARAM_FIELDS:
            setattr(self, name, None)

    def show(self):
        print(self.__class__.__name__)
        for item in self.__dict__.items():
            print(item)
        print()

    def load_values(self, dictionary):
        for key, value in dictionary.items():
            setattr(self, key, value)

    def to_dict(self):
        return dict(self.__dict__)


class HyperParamsDistrib(HyperParams):
    """Random-search space over HyperParams (reference settings.py:66-166)."""

    DEF_BATCH_SIZE = [int(2 ** i) for i in range(1, 10)]
    DEF_BATCH_NORM = [False, True]
    DEF_EPOCHS = list(range(10, 55, 5))
    DEF_LEARNING_RATE = LogUniform(0.001, 0.5)
    DEF_LR_FACTOR = LogUniform(0.01, 1.0)
    DEF_LR_PATIENCE = list(range(1, 10))
    DEF_WEIGHT_DECAY = LogUniform(1e-6, 0.5)
    DEF_DROPOUT_RATE = Uniform(0, 0.9)
    DEF_LOSS_OPTIM = [False, True]
    DEF_DATA_AUGMENT = [False, True]
    DEF_DATA_NORM = [False, True]
    DEF_EARLY_STOP = [False, True]
    DEF_ES_PATIENCE = list(range(10, 20))  # keep greater than lr_patience
    DEF_GRAD_CLIP_NORM = [False, True]
    DEF_GC_MAX_NORM = Uniform(0.01, 10)
    DEF_GRAD_CLIP_VALUE = [False, True]
    DEF_GC_VALUE = Uniform(0.01, 10)
    DEF_INIT_PARAMS = [False, True]

    def __init__(self, **overrides):
        super().__init__()
        unknown = set(overrides) - set(HPARAM_FIELDS)
        if unknown:
            raise TypeError(f"unknown hyper-parameters: {sorted(unknown)}")
        for name in HPARAM_FIELDS:
            value = overrides.get(name)
            if value is None:
                value = getattr(self, "DEF_" + name.upper())
            setattr(self, name, value)


class Settings(HyperParams):
    """Concrete run configuration (reference settings.py:169-319).

    Required: ``kind`` (architecture variant key into each model's ``config``
    dict), ``input_size`` (C, H, W — kept in the reference's CHW order; the
    framework transposes to NHWC internally), ``num_classes``.
    """

    # Defaults (reference settings.py:174-222)
    DEF_BATCH_SIZE = 256
    DEF_BATCH_NORM = True
    DEF_EPOCHS = 50
    DEF_LEARNING_RATE = 0.01
    DEF_LR_FACTOR = 0.1
    DEF_LR_PATIENCE = 10
    DEF_WEIGHT_DECAY = 1e-4
    DEF_DROPOUT_RATE = 0.5
    DEF_LOSS_OPTIM = False
    DEF_DATA_AUGMENT = True
    DEF_DATA_NORM = True
    DEF_EARLY_STOP = True
    DEF_ES_PATIENCE = 12
    DEF_GRAD_CLIP_NORM = False
    DEF_GC_MAX_NORM = 1
    DEF_GRAD_CLIP_VALUE = False
    DEF_GC_VALUE = 1
    DEF_INIT_PARAMS = True

    # Environment defaults
    DEF_SANITY_CHECK = False
    DEF_DEBUG = False
    DEF_NUM_WORKERS = 16
    DEF_MIXED_PRECISION = True
    DEF_TEST_SAMPLE_SIZE = 90
    DEF_SEED = 21

    # Optimizer / LR-schedule selection. The reference hardwires
    # Adam + ReduceLROnPlateau (basemodel.py:58-83); these fields expose the
    # other standard recipes (SGD+momentum, step decay for the ImageNet
    # baseline config, cosine for from-scratch runs) through the same engine.
    DEF_OPTIMIZER = "adam"           # "adam" | "sgd"
    DEF_MOMENTUM = 0.9               # SGD momentum
    DEF_NESTEROV = False
    DEF_LR_SCHEDULER = "plateau"     # "plateau" | "step" | "cosine" | "none"
    DEF_LR_STEP_SIZE = 30            # StepDecay period (epochs)
    DEF_LR_MIN = 0.0                 # cosine floor
    DEF_LR_WARMUP_EPOCHS = 0         # cosine linear warmup
    DEF_AUGMENT_AFFINE = True        # False → crop+flip-only augmentation
    # Gradient loss reduction. "sum" is the reference objective
    # (CrossEntropyLoss(reduction='sum'), basemodel.py:46) — correct for
    # Adam, which is invariant to loss scale. "mean" divides the gradient
    # by the per-batch example count, which standard SGD lr/wd recipes
    # assume. Reported losses are sum-over-batch ÷ dataset either way.
    DEF_LOSS_REDUCTION = "sum"       # "sum" | "mean"
    DEF_LABEL_SMOOTHING = 0.0        # ε for smoothed CE (0 = reference CE)
    DEF_CUTOUT = 0                   # side of the random zeroed square
    #                                  (0 = off); runs on device inside the
    #                                  train step (data/augment.py::cutout)
    DEF_MIXUP = 0.0                  # mixup Beta(α,α) (0 = off); mixes the
    #                                  batch + interpolates the CE loss
    #                                  inside the jitted train step

    # data-parallel environment defaults (replace the reference's DEF_DEVICE)
    DEF_DEVICE_CACHE = None  # None → auto: keep splits resident in HBM when they fit
    DEF_REMAT = False  # rematerialize blocks in backward (HBM vs FLOPs)
    DEF_MESH_SHAPE = None  # None → all visible devices on one 'data' axis
    DEF_DATA_AXIS = "data"
    DEF_OUTPUT_DIR = "data/output"

    ENV_FIELDS = (
        "device_cache",
        "remat",
        "sanity_check",
        "debug",
        "num_workers",
        "mixed_precision",
        "test_sample_size",
        "seed",
        "mesh_shape",
        "data_axis",
        "output_dir",
        "optimizer",
        "momentum",
        "nesterov",
        "lr_scheduler",
        "lr_step_size",
        "lr_min",
        "lr_warmup_epochs",
        "augment_affine",
        "loss_reduction",
        "label_smoothing",
        "cutout",
        "mixup",
    )

    def __init__(
        self,
        kind,
        input_size,
        num_classes,
        batch_size=None,
        batch_norm=None,
        epochs=None,
        learning_rate=None,
        lr_factor=None,
        lr_patience=None,
        weight_decay=None,
        dropout_rate=None,
        loss_optim=None,
        data_augment=None,
        data_norm=None,
        early_stop=None,
        es_patience=None,
        grad_clip_norm=None,
        gc_max_norm=None,
        grad_clip_value=None,
        gc_value=None,
        init_params=None,
        distrib=None,
        sanity_check=None,
        debug=None,
        num_workers=None,
        mixed_precision=None,
        test_sample_size=None,
        seed=None,
        mesh_shape=None,
        data_axis=None,
        output_dir=None,
        device_cache=None,
        remat=None,
        optimizer=None,
        momentum=None,
        nesterov=None,
        lr_scheduler=None,
        lr_step_size=None,
        lr_min=None,
        lr_warmup_epochs=None,
        augment_affine=None,
        loss_reduction=None,
        label_smoothing=None,
        cutout=None,
        mixup=None,
    ):
        super().__init__()

        self.kind = kind
        self.input_size = tuple(input_size)
        self.num_classes = int(num_classes)

        values = dict(
            batch_size=batch_size,
            batch_norm=batch_norm,
            epochs=epochs,
            learning_rate=learning_rate,
            lr_factor=lr_factor,
            lr_patience=lr_patience,
            weight_decay=weight_decay,
            dropout_rate=dropout_rate,
            loss_optim=loss_optim,
            data_augment=data_augment,
            data_norm=data_norm,
            early_stop=early_stop,
            es_patience=es_patience,
            grad_clip_norm=grad_clip_norm,
            gc_max_norm=gc_max_norm,
            grad_clip_value=grad_clip_value,
            gc_value=gc_value,
            init_params=init_params,
            sanity_check=sanity_check,
            debug=debug,
            num_workers=num_workers,
            mixed_precision=mixed_precision,
            test_sample_size=test_sample_size,
            seed=seed,
            mesh_shape=mesh_shape,
            data_axis=data_axis,
            output_dir=output_dir,
            device_cache=device_cache,
            remat=remat,
            optimizer=optimizer,
            momentum=momentum,
            nesterov=nesterov,
            lr_scheduler=lr_scheduler,
            lr_step_size=lr_step_size,
            lr_min=lr_min,
            lr_warmup_epochs=lr_warmup_epochs,
            augment_affine=augment_affine,
            label_smoothing=label_smoothing,
            loss_reduction=loss_reduction,
            cutout=cutout,
            mixup=mixup,
        )
        # None → DEF_* default, via the same reflection scheme as the
        # reference (settings.py:294-299).
        for name, value in values.items():
            if value is None:
                value = getattr(self, "DEF_" + name.upper())
            setattr(self, name, value)

        self.distrib = distrib if distrib is not None else HyperParamsDistrib()

    # -- introspection (reference settings.py:302-319) -----------------

    def get_hparams(self) -> dict:
        return {name: getattr(self, name) for name in HPARAM_FIELDS}

    def get_hparams_names(self):
        return list(HPARAM_FIELDS)

    def to_dict(self):
        d = {name: getattr(self, name) for name in HPARAM_FIELDS}
        d.update(
            kind=self.kind,
            input_size=tuple(self.input_size),
            num_classes=self.num_classes,
        )
        for name in self.ENV_FIELDS:
            d[name] = getattr(self, name)
        return d

    def load_values(self, dictionary):
        for key, value in dictionary.items():
            if key == "distrib":
                continue
            setattr(self, key, value)

    # -- derived -------------------------------------------------------

    @property
    def input_shape_nhwc(self):
        """Reference input_size is (C, H, W); the packages' layout is NHWC."""
        c, h, w = self.input_size
        return (h, w, c)
