"""Run one cell of the benchmark once and print its result.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (h100_bench/configs/<name>.json) and a
traffic mix (h100_bench/traffic/<name>.json), whose `mix` names the
module under h100_bench/mixes/ that drives it; the limits of its check
are h100_bench/limits/<cell>.json. With --trace 0 the result carries the
cell's end-to-end metrics; with --trace 1 its per-layer metrics, each
read by h100_bench/layer_metrics/<metric>.py from a profiled slice of the
window. The last line of standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "convnets_tpu")


def cache_env(root: str = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(bench: dict, name: str, here: str = HERE) -> dict:
    """The cell's entry, configuration, traffic, mix module, limits and
    metrics, each found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    traffic = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    limits_path = os.path.join(here, "limits", name + ".json")
    return {
        "cell": cell,
        "cfg": load_json(os.path.join(here, "configs", cell["config"] + ".json")),
        "traffic": traffic,
        "mix_path": os.path.join(here, "mixes", traffic["mix"] + ".py"),
        "limits": load_json(limits_path)["limits"] if os.path.exists(limits_path) else {},
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """Set-up, the window, the check: the result's fields, and the rows of
    the check (name, value, limit)."""
    import torch

    for path in (ROOT, HERE):  # the program under test, then the benchmark's modules
        if path not in sys.path:
            sys.path.insert(0, path)
    import judge
    import slices
    import work

    ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "seed": int(seed), "device": device,
           "peaks": work.load_peaks(), "batch": int(spec["traffic"]["batch"])}
    mix = load_module(spec["mix_path"], "bench_mix_" + spec["traffic"]["mix"]).Mix(ctx)
    cuda = device.startswith("cuda")
    mix.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    metrics, attempted, sl = mix.window(seconds, trace)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    result = {"attempted": int(attempted), "failed": 0}
    if trace:
        values = {}
        for m in spec["per_layer"]:
            reader = load_module(os.path.join(HERE, "layer_metrics", m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(sl, ctx)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = slices.union_us(slices.busy_intervals(sl)) / 1e6
        dev["window_s"] = sl.window_us / 1e6
        result["breakdown"] = slices.breakdown(sl)
    else:
        values = {name: {"value": float(v), "unit": unit} for name, (v, unit) in metrics.items()}
        values["setup_s"] = {"value": setup_s, "unit": "s"}
    mix.release()
    correct, rows = judge.verdict(mix.numbers(), spec["limits"])
    result.update(correct=correct, metrics=values, device=dev)
    return {"result": result, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench = benchmark()
    spec = cell_spec(bench, args.workload)
    import torch
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    res, rows = out["result"], out["rows"]
    res["device"]["power_limit"] = power_limit()
    res["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(f"correct: {res['correct']}", file=sys.stderr)
    for name, value, limit in rows:  # the numbers compared close standard error
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
