"""Whole runs on the CPU at a small size, past the harness's look for a card,
with the timed path broken underneath: each fault a cell can have must turn
`correct` false under the cell's own limits. The sound run beside them shows
what the faults are read against. (One card, so no exchange between cards
to leave out.)"""

import copy
import time

import numpy as np
import pytest

import run

BENCH = run.benchmark()
SEED = 2 ** 31 + 4242


def small_spec(cell):
    spec = copy.deepcopy(run.cell_spec(BENCH, cell))
    spec["cfg"]["input_size"] = [3, 64, 64]
    spec["traffic"].update(batch=8, images=40, pool=2, sample=4)
    return spec


def run_small(cell, monkeypatch=None, plant=None):
    spec = small_spec(cell)
    if plant is not None:
        plant(monkeypatch)
    return run.run_cell(spec, SEED, 0.0, False, device="cpu", t_start=time.perf_counter())


def numbers(out):
    return {name: value for name, value, _ in out["rows"]}


@pytest.fixture(scope="module")
def sound():
    return {cell: run_small(cell) for cell in ("rn50-train-resident-b256", "rn50-serve-b256")}


def keep_state(monkeypatch):
    """The step returns its state unchanged: Adam gives the parameters back."""
    from convnets_tpu_torch.train import optim

    def unchanged(grads, state, params, **kw):
        return dict(params), state
    monkeypatch.setattr(optim, "adam_update", unchanged)


def half_batch(monkeypatch):
    """Half of each batch left out of the loss, the sum over the rest doubled."""
    from convnets_tpu_torch.train import engine
    real = engine.ops.cross_entropy_sum

    def half(logits, labels, weights=None, label_smoothing=0.0):
        n = logits.shape[0] // 2
        return 2.0 * real(logits[:n], labels[:n], None if weights is None else weights[:n],
                          label_smoothing)
    monkeypatch.setattr(engine.ops, "cross_entropy_sum", half)


def altered_answer(monkeypatch):
    """One logit of each served request changed where it is produced."""
    from convnets_tpu_torch.serve.export import ServingModel
    real = ServingModel.__call__

    def call(self, x):
        y = real(self, x).clone()
        y[0, 0] += 0.1 * float(y.abs().max())
        return y
    monkeypatch.setattr(ServingModel, "__call__", call)


@pytest.mark.parametrize("cell,plant,number", [
    ("rn50-train-resident-b256", keep_state, "change_gap"),
    ("rn50-train-resident-b256", half_batch, "grad_gap"),
    ("rn50-train-resident-b256", half_batch, "replay_grad_gap"),
    ("rn50-serve-b256", altered_answer, "logit_gap"),
], ids=["state_unchanged", "half_batch", "half_batch_replayed_step", "answer_altered"])
def test_fault_turns_correct_false(sound, monkeypatch, cell, plant, number):
    out = run_small(cell, monkeypatch, plant)
    assert out["result"]["correct"] is False
    got, base = numbers(out)[number], numbers(sound[cell])[number]
    limit = dict((n, lim) for n, _, lim in out["rows"])[number]
    assert got > limit and got > 3 * base, (got, base, limit)


def test_sound_runs_report_every_number(sound):
    for cell, out in sound.items():
        names = {n for n, _, _ in out["rows"]}
        assert names == set(run.cell_spec(BENCH, cell)["limits"]), cell
        assert all(np.isfinite(v) for _, v, _ in out["rows"])
