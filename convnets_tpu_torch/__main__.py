"""CLI (counterpart of convnets_tpu/__main__.py): a thin argparse mapping
onto Settings and the drivers.

    python -m convnets_tpu_torch fit --arch resnet --kind 26 --data-root DIR
    python -m convnets_tpu_torch models

The subcommands and flags are the JAX package's, plus --device: the card
by default (`cuda`); without one the command fails naming the missing
device, unless `--device cpu` asks for the CPU. `models` needs no device.

Data parallel: `torchrun --nproc-per-node N -m convnets_tpu_torch fit ...`
trains over every rank (the drivers read torchrun's environment); rank 0
alone prints.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from convnets_tpu_torch.drivers import (
    process_export,
    process_fit,
    process_load,
    process_tune,
)
from convnets_tpu_torch.models import available_models
from convnets_tpu_torch.settings import Settings


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--arch", required=True, choices=available_models())
    p.add_argument("--kind", default="", help="architecture variant key")
    p.add_argument("--input-size", default="3,32,32",
                   help="C,H,W (channels-first, reference convention)")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--data-root", default=None,
                   help="ImageFolder root with train/valid/test splits")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--device", default="cuda",
                   help="where the model and the device-resident splits live: the card "
                        "(cuda, cuda:N) or cpu")
    # hyper-parameters (None → Settings DEF_* defaults)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--dropout-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--no-norm", action="store_true")
    p.add_argument("--no-mixed-precision", action="store_true")
    p.add_argument("--sanity-check", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device-cache", dest="device_cache", action="store_true",
                   default=None, help="force the device-resident split loader")
    p.add_argument("--no-device-cache", dest="device_cache",
                   action="store_false", help="force the host-streaming loader")


def _setting(args) -> Settings:
    try:
        c, h, w = (int(v) for v in args.input_size.split(","))
    except ValueError:
        raise SystemExit(
            f"error: --input-size must be C,H,W integers (got '{args.input_size}')"
        )
    return Settings(
        kind=args.kind,
        input_size=(c, h, w),
        num_classes=args.num_classes,
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        dropout_rate=args.dropout_rate,
        seed=args.seed,
        data_augment=False if args.no_augment else None,
        data_norm=False if args.no_norm else None,
        mixed_precision=False if args.no_mixed_precision else None,
        sanity_check=args.sanity_check or None,
        debug=args.debug or None,
        output_dir=args.output_dir,
        device_cache=getattr(args, "device_cache", None),
    )


def main(argv=None):
    """Parse argv and run its subcommand; under torchrun, ranks other than 0
    print nothing, and the process group the drivers started is destroyed
    at the end."""
    import torch.distributed as dist

    had_group = dist.is_initialized()
    quiet = open(os.devnull, "w") if int(os.environ.get("RANK", "0")) != 0 else None
    try:
        with contextlib.redirect_stdout(quiet) if quiet else contextlib.nullcontext():
            return _main(argv)
    finally:
        if quiet is not None:
            quiet.close()
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()


def _main(argv):
    parser = argparse.ArgumentParser(prog="convnets_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_fit = sub.add_parser("fit", help="train a model from scratch")
    _add_common(p_fit)

    p_tune = sub.add_parser("tune", help="random-search hyper-parameters")
    _add_common(p_tune)
    p_tune.add_argument("--num-iter", type=int, default=3)

    p_load = sub.add_parser("load", help="load a checkpoint / resume / test")
    _add_common(p_load)
    p_load.add_argument("--path", default=None, help="checkpoint path "
                        "(default: latest for this model)")
    p_load.add_argument("--resume", action="store_true")
    p_load.add_argument("--testing", action="store_true")

    p_exp = sub.add_parser(
        "export", help="write a single-file serving artifact (torch.export)")
    _add_common(p_exp)
    p_exp.add_argument("--path", default=None, help="checkpoint path "
                       "(default: latest for this model)")
    p_exp.add_argument("--out", required=True, help="artifact output file")
    p_exp.add_argument("--serve-batch", type=int, default=None,
                       help="fix the serving batch (default: symbolic — "
                       "one artifact serves any batch size)")
    p_exp.add_argument("--probs", action="store_true",
                       help="export softmax probabilities instead of logits")
    p_exp.add_argument("--bake-norm", action="store_true",
                       help="put the dataset normalization into the served "
                       "program (requests then send raw [0,1] pixels)")

    sub.add_parser("models", help="list available architectures")

    args = parser.parse_args(argv)
    if args.cmd == "models":
        print("\n".join(available_models()))
        return 0

    setting = _setting(args)
    common = dict(data_root=args.data_root, device=args.device)
    if args.cmd == "fit":
        process_fit(args.arch, setting, optimizer=args.optimizer, **common)
    elif args.cmd == "tune":
        process_tune(args.arch, setting, num_iter=args.num_iter, optimizer=args.optimizer,
                     **common)
    elif args.cmd == "load":
        process_load(args.arch, setting, path=args.path, resume_training=args.resume,
                     epochs=args.epochs, testing=args.testing, optimizer=args.optimizer,
                     **common)
    elif args.cmd == "export":
        process_export(args.arch, setting, out_path=args.out, ckpt_path=args.path,
                       serve_batch=args.serve_batch,
                       output="probs" if args.probs else "logits",
                       bake_norm=args.bake_norm, **common)
    return 0


if __name__ == "__main__":
    sys.exit(main())
