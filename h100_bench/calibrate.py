"""The readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 h100_bench/calibrate.py --workload <cell> --what program --seeds 1,2,3
    python3 h100_bench/calibrate.py --workload <cell> --what fp8 --seeds 4,5,6
    python3 h100_bench/calibrate.py --workload <cell> --what half_batch --seeds 4,5,6

program: the program's numbers as a run computes them (a train cell's
first steps; a serving cell's requests of a `--seconds` window). fp8:
the control, the reference in float8 in the program's place; bf16: the
reference rounded where a bfloat16 program stores (a witness). half_batch
(train cells): the reference with half of each batch left out of the
loss, the sum over the rest doubled. One JSON line per seed on standard
output. A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "fp8", "bf16", "half_batch"), required=True)
    ap.add_argument("--compute", choices=("bfloat16", "float32"),
                    help="run the program in this compute dtype (a witness)")
    ap.add_argument("--images", type=int, help="the train split's size (a witness)")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.cache_env()
    spec = run.cell_spec(run.benchmark(), args.workload)
    if args.compute:
        spec["cfg"]["precision"]["compute"] = args.compute
    if args.images:
        spec["traffic"]["images"] = args.images
    for path in (run.ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    import work
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "seed": seed, "device": "cuda",
               "peaks": work.load_peaks(), "batch": int(spec["traffic"]["batch"])}
        mix = run.load_module(spec["mix_path"], "bench_mix").Mix(ctx)
        detail = {"detail": True} if spec["traffic"]["mix"] == "train_epochs" else {}
        if args.what == "program":
            mix.setup()
            mix.window(args.seconds, False)
            mix.release()
            numbers = mix.numbers(**detail)
        elif args.what in ("fp8", "bf16"):
            numbers = mix.control_numbers(args.what, **detail)
        else:
            numbers = mix.control_numbers("fp32", half_batch=True, **detail)
        numbers, extra = numbers if isinstance(numbers, tuple) else (numbers, None)
        del mix
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "numbers": numbers, "detail": extra, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
