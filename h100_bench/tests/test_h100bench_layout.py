"""BENCHMARK.json keeps the contract's shape, and every configuration,
traffic mix, mix module, limit file, per-layer reader and kernel group it
names is found by its name."""

import json
import os
import re

import pytest

import run
import slices

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        # every cell that reports the metric reports what it moves
        assert set(m["workloads"]) <= set(moved["workloads"])
        layers.add(m["layer"])
    assert all(len(x) <= 200 and "\n" not in x for x in layers)


def test_cells():
    pairs = set()
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        reports = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in [m["name"] for m in reports] and len(reports) >= 2
        assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    spec = run.cell_spec(BENCH, cell)
    assert spec["cfg"]["name"] == spec["cell"]["config"]
    assert os.path.exists(spec["mix_path"])
    assert spec["limits"], f"no limits/{cell}.json"
    for m in spec["per_layer"]:
        path = os.path.join(run.HERE, "layer_metrics", m["name"] + ".py")
        assert callable(run.load_module(path, "m_" + m["name"].replace(".", "_")).read)


def test_config_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("h100_bench/configs/")
        with open(os.path.join(run.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert all(k in body for k in c["reduced"]), c["reduced"]


@pytest.mark.parametrize("group", ["port", "port_conv", "port_conv_reduce", "library"])
def test_kernel_groups(group):
    g = slices.load_group(group)
    assert g.search("void conv_wgmma_kernel<128, true, false, 1>(Args)") or group not in (
        "port", "port_conv")


def test_kernel_groups_split_cleanly():
    port, lib = slices.load_group("port"), slices.load_group("library")
    for name in ("void conv_wgmma_kernel<64, true, true, 4>(Args)",
                 "void bn_act_apply_kernel<__nv_bfloat16, true, 8>(...)",
                 "void pool_bwd_kernel<__nv_bfloat16, false, 8>(...)"):
        assert port.search(name) and not lib.search(name)
    for name in ("sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
                 "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT"):
        assert lib.search(name) and not port.search(name)
    assert not lib.search("void at::native::vectorized_elementwise_kernel<4, AddFunctor>")
