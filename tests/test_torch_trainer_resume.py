"""The port's Trainer (train/engine.py) on the CPU: resume, the plateau
rollback, early stop, the async checkpoint, fit(debug=True) and Adam's
state across both packages' checkpoints.

Split from tests/test_torch_trainer.py, whose tests share the
module-scoped `fits` fixture, so that pytest-xdist's loadfile
distribution can run the two files on two workers. These tests need no
`fits`: each fits its own RN18@32 at batch 8 in fp32 from the settings and
loaders of test_torch_trainer.py (`_kw`, `_loaders`), except the
uninterrupted fit that both resume cases compare against, which the
module-scoped `straight_fit` runs once. The Adam-state test's JAX
Trainer takes numpy weights in the layout jax.eval_shape gives, not a JAX
init (10 s of the file's CPU time).
"""

import copy
import threading

import numpy as np
import pytest
import jax
import torch

from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu.train import Trainer as JTrainer
from convnets_tpu.train import checkpoint as jckpt
from convnets_tpu.train.state import create_train_state as jax_train_state
from convnets_tpu_torch import bridge
from convnets_tpu_torch.data import DeviceCacheLoader
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.parallel import init_distributed
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.train.graph import StepGraph
from test_torch_trainer import BATCH, _arrays, _flat, _kw, _loaders
from test_torch_zoo_attention import numpy_variables
from torch_one_thread import one_intra_op_thread  # noqa: F401


def test_adam_state_crosses_both_ways(tmp_path):
    jt = JTrainer(jax_build_model("resnet", JSettings(**_kw(tmp_path / "jax", optimizer="adam"))),
                  use_mesh=False)
    variables = numpy_variables(jax.eval_shape(jt.model.init, jax.random.key(0)), 18)
    jt.state = jax_train_state(variables, jt.setting, "adam")
    tt = Trainer(build_model("resnet", Settings(**_kw(tmp_path / "port", optimizer="adam")),
                             device="cpu"))
    bridge.load_jax_variables(tt.model, variables)
    jt.init_optimizer()
    rng = np.random.RandomState(4)
    jt.state = jt.state._replace(opt_state=jt.state.opt_state._replace(
        count=np.asarray(7, np.int32),
        mu=jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), jt.state.opt_state.mu),
        nu=jax.tree.map(lambda a: rng.rand(*a.shape).astype(np.float32), jt.state.opt_state.nu)))
    path = jt.save_checkpoint(str(tmp_path / "jax.ckpt.npz"))
    tt.load_checkpoint(path)
    assert tt.state.optimizer == "adam" and tt.state.opt_state.count == 7
    back = tt.save_checkpoint(str(tmp_path / "port.ckpt.npz"))
    jt.load_checkpoint(back)
    want, got = jckpt.load_checkpoint(path)[0], jckpt.load_checkpoint(back)[0]
    for coll in ("params", "model_state", "opt_state"):
        a, b = _flat(want[coll]), _flat(got[coll])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{coll}/{k}")
    assert int(jt.state.opt_state.count) == 7


def _state_of(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in trainer.state.opt_state.momentum.items()})


RESUME_KW = dict(dropout_rate=0.5, batch_norm=True)
STRAIGHT = 3  # the longest uninterrupted fit of the resume cases


@pytest.fixture(scope="module")
def straight_fit(tmp_path_factory):
    """The uninterrupted fit of STRAIGHT epochs, run once for both resume
    cases: its states at the end of each epoch (read in the epoch hook) and
    its per-epoch history. The schedule (step decay per epoch), the shuffle
    and the dropout masks of an epoch do not depend on the number of
    epochs, so its first epochs are those of any shorter fit."""
    ends = {}
    a = Trainer(build_model("resnet", Settings(**_kw(tmp_path_factory.mktemp("a"),
                                                      epochs=STRAIGHT, **RESUME_KW)),
                            device="cpu"))
    a.epoch_hook = lambda trainer, epoch: ends.__setitem__(epoch, _state_of(trainer))
    a.fit(*_loaders("port"))
    a.close()
    return ends, a.epoch_results


@pytest.mark.parametrize("straight,first", [(2, 1), (3, 2)])
def test_resume_is_bit_identical_to_an_uninterrupted_fit(tmp_path, straight_fit, straight,
                                                          first):
    """Fit `straight` epochs, or fit `first` and resume for 1 in a fresh
    Trainer on fresh loaders: the resumed epoch ends with every parameter,
    buffer and momentum leaf equal to the uninterrupted fit's at the same
    epoch, with dropout on (the port's counterpart of
    tests/test_resume_order.py). Resume starts from the best epoch of the
    first fit, so that is the epoch compared; the states are read in the
    epoch hook (at its end fit reloads the best checkpoint). The
    uninterrupted fit is `straight_fit`'s, of STRAIGHT >= `straight`
    epochs, compared at an epoch before `straight`."""
    kw = RESUME_KW
    ends, a_results = straight_fit
    b = Trainer(build_model("resnet", Settings(**_kw(tmp_path / "b", epochs=first, **kw)),
                            device="cpu"))
    b.fit(*_loaders("port"))
    b.close()
    best = b.epoch_results["train_epochs"]
    c = Trainer(build_model("resnet", Settings(**_kw(tmp_path / "c", epochs=1, **kw)),
                            device="cpu"))
    c.load_checkpoint(b.model_path)
    c.setting.epochs = 1  # the file's settings were re-applied on load
    c.epoch_hook = lambda trainer, epoch: ends.__setitem__(("c", epoch), _state_of(trainer))
    train, valid = _loaders("port")
    c.fit(train, valid, resume=True)
    c.close()
    assert train.epoch == best + 1 and best < straight <= STRAIGHT
    (sa, ma), (sc, mc) = ends[best], ends["c", 0]
    assert set(sa) == set(sc) and set(ma) == set(mc)
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    for k in ma:
        assert torch.equal(ma[k], mc[k]), k
    for k in ("train_loss", "valid_loss", "learning_rate"):
        assert a_results[k][:best + 1] == c.epoch_results[k], k


def _scripted_eval(trainer, losses):
    """Replace the valid epoch by a scripted series of (loss, score): the
    control flow of fit, not the numbers of the model, is under test."""
    it = iter(losses)
    trainer._run_eval_epoch = lambda loader, collect_preds=False: (next(it), 0.5)


def test_plateau_drop_rolls_back_params_and_buffers_but_not_the_moments(tmp_path):
    tt = Trainer(build_model("resnet", Settings(**_kw(
        tmp_path, epochs=2, lr_scheduler="plateau", lr_patience=0, loss_optim=True)),
        device="cpu"))
    _scripted_eval(tt, [1.0, 2.0])
    seen = []
    run_train = tt._run_train_epoch

    def train_epoch(loader, epoch_index):
        out = run_train(loader, epoch_index)
        seen.append(("trained",) + _state_of(tt))
        return out

    tt._run_train_epoch = train_epoch
    lrs = []
    tt.epoch_hook = lambda trainer, epoch: (seen.append(("hook",) + _state_of(trainer)),
                                            lrs.append((trainer.scheduler.lr, trainer.state.lr)))
    tt.fit(*_loaders("port", n_train=16))
    tt.close()
    (_, p1, m1), (_, b1, _), (_, p2, m2), (_, b2, h2) = seen
    assert lrs == [(1e-3, 1e-3), (5e-4, 5e-4)]
    assert tt.epoch_results["learning_rate"] == [1e-3, 1e-3]
    assert not all(torch.equal(p1[k], p2[k]) for k in p1)  # epoch 2 moved the weights
    for k in b1:  # ... and the drop put back epoch 1's params and BN buffers
        assert torch.equal(b2[k], p1[k]), k
    assert any("running_var" in k for k in b2)
    for k in m2:  # the moments stay those of epoch 2
        assert torch.equal(h2[k], m2[k]), k
    assert not all(torch.equal(m1[k], m2[k]) for k in m1)


@pytest.mark.parametrize("es_patience", [0, 2])
def test_early_stop_after_es_patience_plus_one_non_improving_epochs(tmp_path, es_patience):
    tt = Trainer(build_model("resnet", Settings(**_kw(
        tmp_path, epochs=6, lr_scheduler="none", loss_optim=True, early_stop=True,
        es_patience=es_patience)), device="cpu"))
    _scripted_eval(tt, [1.0] + [2.0] * 5)
    tt.fit(*_loaders("port", n_train=16))
    tt.close()
    ran = 1 + es_patience + 1
    assert len(tt.epoch_results["train_loss"]) == tt.epoch_results["total_epochs"] == ran
    assert tt.epoch_results["train_epochs"] == 1  # the best epoch's checkpoint


def test_an_async_checkpoint_holds_the_weights_from_before_the_next_step(tmp_path, monkeypatch):
    """The writer is held on an event while a train step overwrites the
    live tensors in place; the file must hold the weights it was asked to
    save."""
    tt = Trainer(build_model("resnet", Settings(**_kw(tmp_path)), device="cpu"))
    tt.init_state()
    tt.init_optimizer()
    release, write = threading.Event(), ckpt.save_checkpoint

    def held_write(*args, **kwargs):
        assert release.wait(timeout=60)
        return write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_write)
    before = copy.deepcopy(bridge.export_jax_variables(tt.model))
    momentum = {k: v.clone() for k, v in tt.state.opt_state.momentum.items()}
    path = tt.save_checkpoint(block=False)
    x, y = _arrays(BATCH, 5)
    tt._get_train_step(False, True)(tt.state, torch.from_numpy(x), torch.from_numpy(y))
    after = bridge.export_jax_variables(tt.model)
    release.set()
    tt.close()
    trees, _ = ckpt.load_checkpoint(path)
    saved, moved = _flat(trees["params"]), 0
    for k, v in _flat(before["params"]).items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
        moved += not np.array_equal(_flat(after["params"])[k], v)
    assert moved > 0
    saved_state = _flat(trees["model_state"])
    for k, v in _flat(before["state"]).items():
        np.testing.assert_array_equal(saved_state[k], v, err_msg=k)
    saved_opt = _flat(trees["opt_state"]["momentum"])
    paths = bridge.param_paths(tt.model)
    for name, v in momentum.items():
        np.testing.assert_array_equal(saved_opt["/".join(paths[name])], v.numpy())


def test_fit_debug_prints_the_trace_and_gradient_norms(tmp_path, capsys, monkeypatch):
    tt = Trainer(build_model("resnet", Settings(**_kw(tmp_path, epochs=1, debug=True,
                                                       sanity_check=True)), device="cpu"))
    tt.fit(*_loaders("port", n_train=16))
    tt.close()
    out = capsys.readouterr().out
    assert "grad_norm=" in out and "total params" in out and "not ported" not in out
    trace = [line for line in out.splitlines() if line.startswith("[trace] ")]
    assert trace and out.index(trace[-1]) < out.index("grad_norm=")  # before the first epoch
    tt.debug_trace()
    assert capsys.readouterr().out.count("[trace] ") == len(trace)
    # the data path is ported: an augmented fit runs (per-step under debug),
    # and a loader that offers the whole-epoch scan takes the replayed-graph
    # route once debug and sanity_check are off
    train, valid = _loaders("port", n_train=16)
    tt.setting.data_augment = True
    tt.fit(train, valid)
    assert "grad_norm=" in capsys.readouterr().out
    tt.setting.data_augment = False
    tt.setting.debug = tt.setting.sanity_check = False
    scanning = DeviceCacheLoader(train.dataset, BATCH, shuffle=True, device="cpu")
    assert scanning.scan_epochs and tt._use_epoch_scan(scanning)
    runs = []
    replay = StepGraph.run
    monkeypatch.setattr(StepGraph, "run", lambda g, *a, **k: runs.append(g.kind) or
                        replay(g, *a, **k))
    tt.fit(scanning, valid)
    assert "grad_norm=" not in capsys.readouterr().out
    assert runs == ["train"] * tt.setting.epochs  # valid is a DataLoader: per-step
    tt.close()
    # the Trainer takes a mesh: here a world of one over gloo, on whose
    # per-step route (gloo's collectives are not captured) it trains
    init_distributed(device="cpu")
    try:
        meshed = Trainer(tt.model, use_mesh=True)
        assert meshed.mesh.mesh_dim_names == ("data",) and meshed.world == 1
        assert not meshed._use_epoch_scan(scanning)
        meshed._new_state()
        assert np.isfinite(meshed._run_train_epoch(train, 0)).all()
    finally:
        torch.distributed.destroy_process_group()
    assert next(tt.model.parameters()).device.type == "cpu"
    fresh = Trainer(tt.model)
    with pytest.raises(RuntimeError, match="load_checkpoint"):
        fresh.evaluate(valid)
