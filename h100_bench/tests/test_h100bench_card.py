"""The command itself: without the program it exits non-zero and prints no
result; on a card, one short run prints the result line the driver reads."""

import json
import os
import shutil
import subprocess
import sys

import run


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "rn50-serve-b256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_one_short_run_on_the_card(card):
    r = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "rn50-serve-b256",
                        "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
                       cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"serve_img_s", "serve_p95_ms", "setup_s"} == set(res["metrics"])
