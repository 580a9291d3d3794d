"""The control: the reference put in the program's place in float8 (the
precision below the configurations' bfloat16) must come out not correct
under each cell's limits. On the card at the cells' sizes the readings
come from calibrate.py; here it runs at a size a test run holds."""

import copy

import pytest

import judge
import run

BENCH = run.benchmark()
SEED = 2 ** 31 + 777


def small_mix(cell):
    spec = copy.deepcopy(run.cell_spec(BENCH, cell))
    spec["cfg"]["input_size"] = [3, 64, 64]
    spec["traffic"].update(batch=8, images=40, pool=2, sample=4)
    ctx = {"cfg": spec["cfg"], "traffic": spec["traffic"], "seed": SEED, "device": "cpu",
           "peaks": {}, "batch": 8}
    return spec, run.load_module(spec["mix_path"], "mix_" + spec["traffic"]["mix"]).Mix(ctx)


@pytest.mark.parametrize("cell", ["rn50-train-resident-b256", "rn50-serve-b256"])
def test_float8_control_is_not_correct(cell):
    spec, mix = small_mix(cell)
    correct, rows = judge.verdict(mix.control_numbers("fp8"), spec["limits"])
    assert correct is False, rows


def test_reference_against_itself_is_correct():
    """The same comparison of the float32 reference with itself reads 0 on
    every number: the control fails by its precision, not by the harness."""
    spec, mix = small_mix("rn50-train-resident-b256")
    numbers = mix.control_numbers("fp32")
    assert all(v == 0.0 for v in numbers.values()), numbers
