"""The port's Trainer slice (train/engine.py Trainer and build_eval_step,
train/checkpoint.py, train/scheduler.py, train/metrics.py, core/rng.py,
settings.py) against the JAX package on the CPU.

Both packages run RN18@32 at batch 8 in fp32 with SGD (momentum 0.9, the
per-example-mean objective, lr 1e-3), dropout 0 and no augmentation, from
the same JAX-initialized weights (crossed by the bridge) and the same uint8
arrays under the same seeded loaders; the JAX Trainer runs without a mesh.

Why the BN net's fit runs at batch 32 (2 steps per epoch, 3 epochs) and
its checkpoint is held per leaf against a witness: at batch 8 its last
stage normalizes each channel over 8 values, and the JAX package against
itself, with its conv weights x(1 + 1e-7·N(0,1)), parts within a few steps
as fast as the two packages do. At batch 32 both packages' epoch losses
agree to 2.3e-5, and every leaf to 1e-3 except the last block's two BN
biases (zero at init, the same gradient) and two others, which the
witness moves by the same amounts: 5.436e-3 and 1.370e-3 against the
port's 5.437e-3 and 1.367e-3. So each leaf is held to the larger of
PARAM_RTOL and WITNESS_FACTOR times the witness's own drift on it. The
BN-free RN18 carries the same 3 epochs at batch 8, every leaf within
PARAM_RTOL.
"""

import copy
import json
import threading

import numpy as np
import pytest
import jax
import torch

from convnets_tpu.core import rng as jrng
from convnets_tpu.data import ArrayDataset as JArrayDataset
from convnets_tpu.data import DataLoader as JDataLoader
from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu.train import Trainer as JTrainer
from convnets_tpu.train import checkpoint as jckpt
from convnets_tpu.train import metrics as jmetrics
from convnets_tpu.train import scheduler as jsched
from convnets_tpu_torch import bridge
from convnets_tpu_torch.core.rng import generator_for
from convnets_tpu_torch.data import ArrayDataset, DataLoader, synthetic_dataset
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer, build_eval_step
from convnets_tpu_torch.train import checkpoint as ckpt
from convnets_tpu_torch.train import metrics
from convnets_tpu_torch.train import scheduler as sched

N_TRAIN, N_VALID, BATCH = 32, 20, 8  # the valid split's last batch: 4 real rows, 4 padded
BN_TRAIN, BN_BATCH = 64, 32  # the BN net's fit (see the module docstring)
LOSS_RTOL = 1e-3  # each epoch's train and valid loss
PARAM_RTOL = 1e-3  # max|Δ| / max|leaf| per leaf of the best checkpoint
WITNESS, WITNESS_FACTOR = 1e-7, 10.0  # the BN fit's witness: JAX with perturbed conv weights
EVAL_RTOL = 1e-4  # the eval loss of one checkpoint in both packages
BN_RTOL = 1e-5  # re-estimated running statistics, per leaf


def _kw(tmp, **kw):
    base = dict(kind="18", input_size=(3, 32, 32), num_classes=10, mixed_precision=False,
                batch_size=BATCH, epochs=3, optimizer="sgd", learning_rate=1e-3,
                loss_reduction="mean", lr_scheduler="step", lr_step_size=1, lr_factor=0.5,
                data_augment=False, data_norm=True, dropout_rate=0.0, early_stop=False,
                output_dir=str(tmp), test_sample_size=4)
    base.update(kw)
    return base


def _arrays(n, seed):
    ds = synthetic_dataset(n, seed=seed)
    return (ds.images * 255).round().astype(np.uint8), ds.labels


def _loaders(pkg, batch=BATCH, n_train=N_TRAIN):
    """(train, valid) loaders over the same uint8 arrays in either package."""
    dataset, loader = (JArrayDataset, JDataLoader) if pkg == "jax" else (ArrayDataset, DataLoader)
    return (loader(dataset(*_arrays(n_train, 0)), batch, shuffle=True, seed=0),
            loader(dataset(*_arrays(N_VALID, 1)), batch))


def _jax_variables(state):
    return {"params": jax.tree.map(np.asarray, state.params),
            "state": jax.tree.map(np.asarray, state.model_state)}


def _pair(tmp, **kw):
    """A JAX Trainer with fresh weights and a port Trainer holding the same."""
    jt = JTrainer(jax_build_model("resnet", JSettings(**_kw(tmp / "jax", **kw))), use_mesh=False)
    jt.init_state()
    model = build_model("resnet", Settings(**_kw(tmp / "port", **kw)), device="cpu")
    bridge.load_jax_variables(model, _jax_variables(jt.state))
    return jt, Trainer(model)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """fits(batch_norm) -> both packages fitted for 3 epochs from the same
    weights: the BN-free net at batch 8, the BN net at batch 32, with the
    witness beside it (see the module docstring)."""
    done = {}

    def get(batch_norm):
        if batch_norm not in done:
            tmp = tmp_path_factory.mktemp("bn" if batch_norm else "nobn")
            kw = dict(batch_norm=batch_norm, **({"batch_size": BN_BATCH} if batch_norm else {}))
            jt, tt = _pair(tmp, **kw)
            start = _jax_variables(jt.state)
            loaders = lambda pkg: (_loaders(pkg, BN_BATCH, BN_TRAIN) if batch_norm
                                   else _loaders(pkg))
            jt.fit(*loaders("jax"))
            jt.close()
            tt.fit(*loaders("port"))
            tt.close()
            done[batch_norm] = dict(jt=jt, tt=tt, tmp=tmp, jax_path=jt.model_path,
                                    port_path=tt.model_path,
                                    jax_results=copy.deepcopy(jt.epoch_results),
                                    port_results=copy.deepcopy(tt.epoch_results))
            if batch_norm:  # the witness: the same JAX Trainer again (compiled once)
                rng = np.random.default_rng(1)
                jt.state = jt.state._replace(model_state=start["state"], params=jax.tree.map(
                    lambda a: (a * (1 + WITNESS * rng.standard_normal(a.shape))).astype(a.dtype)
                    if a.ndim == 4 else a, start["params"]))
                jt.model_path = str(tmp / "witness.ckpt.npz")
                jt.fit(*loaders("jax"))
                jt.close()
                done[batch_norm]["witness_path"] = jt.model_path
        return done[batch_norm]

    return get


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in bridge._flatten(tree).items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("batch_norm", [False, True], ids=["no-bn-3-epochs", "bn-3-epochs-b32"])
def test_fit_matches_jax(fits, batch_norm):
    f = fits(batch_norm)
    want, got = f["jax_results"], f["port_results"]
    assert got["learning_rate"] == want["learning_rate"]
    assert len(got["learning_rate"]) == 3
    for k in ("train_epochs", "total_epochs"):
        assert got[k] == want[k], k
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    for k, n in (("train_score", BN_TRAIN if batch_norm else N_TRAIN),
                 ("valid_score", N_VALID)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1.0 / n + 1e-9, err_msg=k)
    assert got["train_time"] > 0
    jtrees, _ = jckpt.load_checkpoint(f["jax_path"])
    ttrees, _ = ckpt.load_checkpoint(f["port_path"])
    wtrees = jckpt.load_checkpoint(f["witness_path"])[0] if batch_norm else None
    for coll in ("params", "model_state"):
        want_leaves, got_leaves = _flat(jtrees[coll]), _flat(ttrees[coll])
        assert set(got_leaves) == set(want_leaves)
        assert bool(want_leaves) == (coll == "params" or batch_norm)
        for k in want_leaves:
            bar = PARAM_RTOL
            if batch_norm:  # the reference's own drift on this leaf
                bar = max(bar, WITNESS_FACTOR * _rel(_flat(wtrees[coll])[k], want_leaves[k]))
            assert _rel(got_leaves[k], want_leaves[k]) <= bar, (coll, k)


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return {prefix + k for k in tree} | {x for k, v in tree.items()
                                             for x in _keys(v, f"{prefix}{k}/")}
    return set()


def test_a_port_checkpoint_has_the_keys_of_a_jax_one(fits):
    f = fits(True)
    with np.load(f["jax_path"]) as jz, np.load(f["port_path"]) as tz:
        assert set(tz.files) == set(jz.files)
        for k in jz.files:
            assert (tz[k].dtype, tz[k].shape) == (jz[k].dtype, jz[k].shape) or k == "__meta__", k
        jmeta, tmeta = (json.loads(bytes(z["__meta__"]).decode()) for z in (jz, tz))
    assert _keys(tmeta) == _keys(jmeta)
    assert tmeta["format_version"] == jmeta["format_version"]
    assert tmeta["optimizer"] == jmeta["optimizer"] == "sgd"
    best = jmeta["epoch_results"]["train_epochs"]
    assert tmeta["extra"]["loader_epochs"] == jmeta["extra"]["loader_epochs"] == \
        {"train": best, "valid": best}
    assert tmeta["settings"] == {**jmeta["settings"], "output_dir": tmeta["settings"]["output_dir"]}


def test_the_jax_trainer_resumes_a_port_checkpoint(fits):
    f = fits(True)
    jt, tt = f["jt"], f["tt"]
    meta = jt.load_checkpoint(f["port_path"])
    assert meta["epoch_results"] == f["port_results"]
    best = meta["epoch_results"]["train_epochs"]  # read now: fit updates this dict
    tt.load_checkpoint(f["port_path"])
    jloss, jscore = jt._run_eval_epoch(_loaders("jax")[1])
    tloss, tscore = tt._run_eval_epoch(_loaders("port")[1])
    assert abs(tloss - jloss) <= EVAL_RTOL * abs(jloss)
    assert abs(tscore - jscore) <= 1.0 / N_VALID + 1e-9
    assert tt.evaluate(_loaders("port")[1], info=False) == \
        pytest.approx(jt.evaluate(_loaders("jax")[1], info=False), abs=1.0 / N_VALID + 1e-9)
    assert tt.confusion_matrix.sum() == N_VALID
    jt.setting.epochs = 1
    jt.model_path = str(f["tmp"] / "jax-resumed.ckpt.npz")  # keep the fixture's file
    jt.fit(*_loaders("jax"), resume=True)
    jt.close()
    assert jt.epoch_results["total_epochs"] == best + 1


def test_a_jax_checkpoint_loads_into_the_port_exactly_and_resumes(fits, tmp_path):
    f = fits(True)
    trees, meta = jckpt.load_checkpoint(f["jax_path"])
    model = build_model("resnet", Settings(**_kw(tmp_path, batch_norm=True, epochs=1)),
                        device="cpu")
    tt = Trainer(model, optimizer="adam")
    tt.load_checkpoint(f["jax_path"])
    got = bridge.export_jax_variables(model)
    for coll, jcoll in (("params", "params"), ("state", "model_state")):
        want_leaves, got_leaves = _flat(trees[jcoll]), _flat(got[coll])
        assert set(got_leaves) == set(want_leaves)
        for k in want_leaves:
            np.testing.assert_array_equal(got_leaves[k], want_leaves[k], err_msg=k)
    assert tt.optimizer_name == tt.state.optimizer == "sgd"
    want_opt = _flat(trees["opt_state"])
    got_opt = _flat(bridge.export_jax_opt_state(model, tt.state.opt_state))
    assert set(got_opt) == set(want_opt)
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], want_opt[k], err_msg=k)
    assert tt.epoch_results == meta["epoch_results"]
    assert tt.scheduler.to_state() == meta["scheduler"]
    assert tt.state.lr == float(trees["lr"])
    best = meta["epoch_results"]["train_epochs"]
    assert tt._resume_loader_epochs == {"train": best, "valid": best}
    tt.setting.epochs = 1  # the file's settings (3 epochs) were re-applied on load
    train, valid = _loaders("port")
    tt.fit(train, valid, resume=True)
    tt.close()
    assert tt.epoch_results["total_epochs"] == best + 1 and train.epoch == best + 1
    assert tt.epoch_results["learning_rate"][-1] == 1e-3 * 0.5 ** best  # the step schedule


def test_adam_state_crosses_both_ways(tmp_path):
    jt, tt = _pair(tmp_path, optimizer="adam")
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


@pytest.mark.parametrize("straight,first", [(2, 1), (3, 2)])
def test_resume_is_bit_identical_to_an_uninterrupted_fit(tmp_path, straight, first):
    """Fit `straight` epochs, or fit `first` and resume for 1 in a fresh
    Trainer on fresh loaders: the resumed epoch ends with every parameter,
    buffer and momentum leaf equal to the uninterrupted fit's at the same
    epoch, with dropout on (the port's counterpart of
    tests/test_resume_order.py). Resume starts from the best epoch of the
    first fit, so that is the epoch compared; the states are read in the
    epoch hook (at its end fit reloads the best checkpoint)."""
    kw = dict(dropout_rate=0.5, batch_norm=True)
    ends = {}
    a = Trainer(build_model("resnet", Settings(**_kw(tmp_path / "a", epochs=straight, **kw)),
                            device="cpu"))
    a.epoch_hook = lambda trainer, epoch: ends.__setitem__(("a", epoch), _state_of(trainer))
    a.fit(*_loaders("port"))
    a.close()

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
    assert train.epoch == best + 1
    (sa, ma), (sc, mc) = ends["a", best], ends["c", 0]
    assert set(sa) == set(sc) and set(ma) == set(mc)
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    for k in ma:
        assert torch.equal(ma[k], mc[k]), k
    for k in ("train_loss", "valid_loss", "learning_rate"):
        assert a.epoch_results[k][:best + 1] == c.epoch_results[k], k


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


def test_reestimate_bn_matches_jax_over_full_batches_only(fits, capsys):
    f = fits(True)
    jt, tt = f["jt"], f["tt"]
    jt.load_checkpoint(f["jax_path"])
    tt.load_checkpoint(f["jax_path"])
    params = {k: p.detach().clone() for k, p in tt.model.named_parameters()}
    tt.model.eval()
    jt.reestimate_bn(JDataLoader(JArrayDataset(*_arrays(N_VALID, 2)), BATCH, shuffle=True),
                     passes=2)
    capsys.readouterr()
    tt.reestimate_bn(DataLoader(ArrayDataset(*_arrays(N_VALID, 2)), BATCH, shuffle=True),
                     passes=2)
    # 20 images at batch 8: 2 full batches per pass, the padded third skipped
    assert "over 4 train-mode batches" in capsys.readouterr().out
    assert not tt.model.training
    for k, p in tt.model.named_parameters():
        assert torch.equal(p, params[k]), k
    want = _flat(_jax_variables(jt.state)["state"])
    got = _flat(bridge.export_jax_variables(tt.model)["state"])
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= BN_RTOL, k


def test_test_returns_subset_scores_times_and_fps_and_repins_the_loader(fits):
    f = fits(True)
    jt, tt = f["jt"], f["tt"]
    jt.load_checkpoint(f["jax_path"])
    tt.load_checkpoint(f["jax_path"])
    loader = DataLoader(ArrayDataset(*_arrays(N_VALID, 1)), BATCH, shuffle=True, seed=3)
    loader.epoch = 5
    scores, times, fps = tt.test(loader, num_warmup=1)
    assert loader.epoch == 1
    assert len(times) == len(loader) and (times > 0).all() and fps > 0
    assert len(scores) == 4 and all(0.0 <= s <= 1.0 for s in scores)
    assert tt.confusion_matrix.sum() == N_VALID
    again, _, _ = tt.test(loader, num_warmup=0)
    assert again == scores
    jloader = JDataLoader(JArrayDataset(*_arrays(N_VALID, 1)), BATCH, shuffle=True, seed=3)
    jscores, _, _ = jt.test(jloader, num_warmup=1)
    assert scores == jscores


def test_the_eval_step_matches_jax(fits):
    f = fits(True)
    jt, tt = f["jt"], f["tt"]
    jt.load_checkpoint(f["jax_path"])
    tt.load_checkpoint(f["jax_path"])
    x, y = _arrays(BATCH, 6)
    w = np.array([1] * 6 + [0] * 2, np.float32)
    stats = jt._resolve_stats(_loaders("jax")[1])
    jl, jc, jp = jt._get_eval_step(True, stats)(jt.state, x, y, w)
    tt.model.train()
    tl, tc, tp = build_eval_step(tt.model, True, stats)(torch.from_numpy(x), torch.from_numpy(y),
                                                         torch.from_numpy(w))
    assert not tt.model.training
    assert abs(float(tl) - float(jl)) <= EVAL_RTOL * abs(float(jl))
    assert float(tc) == float(jc)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("kind", ["plateau", "step", "cosine", "none"])
def test_schedulers_match_jax(kind):
    make = {"plateau": lambda m: m.ReduceLROnPlateau(0.1, mode="min", factor=0.5, patience=1),
            "step": lambda m: m.StepDecay(0.1, step_size=2, gamma=0.3),
            "cosine": lambda m: m.CosineDecay(0.1, total_epochs=7, min_lr=1e-3, warmup_epochs=2),
            "none": lambda m: m.ConstantLR(0.1)}[kind]
    metrics_ = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.86, 0.87, 0.5, 0.6]
    mine, theirs = make(sched), make(jsched)
    assert mine.lr == theirs.lr
    for i, m in enumerate(metrics_):
        assert mine.step(m) == theirs.step(m), i
        assert mine.to_state() == theirs.to_state()
        if i == 4:  # a round trip mid-run carries on identically
            mine = sched.scheduler_from_state(json.loads(json.dumps(mine.to_state())))
            assert type(mine).__name__ == type(theirs).__name__


def test_metrics_match_jax():
    rng = np.random.RandomState(8)
    y, p = rng.randint(0, 6, 200), rng.randint(0, 6, 200)
    p[:90] = y[:90]
    assert metrics.accuracy_score(y, p) == jmetrics.accuracy_score(y, p)
    np.testing.assert_array_equal(metrics.confusion_matrix(y, p, 7),
                                  jmetrics.confusion_matrix(y, p, 7))
    names = [f"c{i}" for i in range(7)]
    assert metrics.classification_report(y, p, 7, names) == \
        jmetrics.classification_report(y, p, 7, names)
    assert metrics.classification_report(y, p, 7) == jmetrics.classification_report(y, p, 7)


def test_generator_streams_are_fixed_and_distinct():
    from convnets_tpu_torch.core import rng

    assert rng._STREAMS == jrng._STREAMS
    draw = lambda *a: torch.rand(64, generator=generator_for(*a))
    assert torch.equal(draw(21, "dropout", 3, 7), draw(21, "dropout", 3, 7))
    others = [draw(21, "dropout", 3, 8), draw(21, "dropout", 4, 7), draw(22, "dropout", 3, 7),
              draw(21, "bn_reestimate", 3, 7), draw(21, "dropout", 3)]
    assert not any(torch.equal(draw(21, "dropout", 3, 7), o) for o in others)
    with pytest.raises(KeyError):
        generator_for(0, "nope")


def test_settings_are_the_jax_ones():
    kw = dict(kind="26", input_size=(3, 32, 32), num_classes=10, epochs=4, optimizer="sgd")
    mine, theirs = Settings(**kw), JSettings(**kw)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.get_hparams_names() == theirs.get_hparams_names()
    assert mine.input_shape_nhwc == theirs.input_shape_nhwc == (32, 32, 3)
    defaults = {k: v for k, v in vars(JSettings).items() if k.startswith("DEF_")}
    assert {k: v for k, v in vars(Settings).items() if k.startswith("DEF_")} == defaults
    mine.load_values({"learning_rate": 0.5, "distrib": None})
    assert mine.learning_rate == 0.5 and mine.distrib is not None


def test_fit_debug_prints_gradient_norms_and_refuses_what_is_not_ported(tmp_path, capsys):
    tt = Trainer(build_model("resnet", Settings(**_kw(tmp_path, epochs=1, debug=True,
                                                       sanity_check=True)), device="cpu"))
    tt.fit(*_loaders("port", n_train=16))
    tt.close()
    out = capsys.readouterr().out
    assert "grad_norm=" in out and "total params" in out and "item 8" in out
    with pytest.raises(NotImplementedError, match="item 8"):
        tt.debug_trace()
    train, valid = _loaders("port", n_train=16)
    tt.setting.data_augment = True
    with pytest.raises(NotImplementedError, match="item 3"):
        tt.fit(train, valid)
    tt.setting.data_augment = False
    train.scan_epochs = True
    with pytest.raises(NotImplementedError, match="item 3"):
        tt.fit(train, valid)
    with pytest.raises(NotImplementedError, match="item 7"):
        Trainer(tt.model, use_mesh=True)
    assert next(tt.model.parameters()).device.type == "cpu"
    fresh = Trainer(tt.model)
    with pytest.raises(RuntimeError, match="load_checkpoint"):
        fresh.evaluate(valid)


def test_tree_averages_match_jax():
    rng = np.random.RandomState(9)
    trees = [{"a": rng.randn(3, 2).astype(np.float32),
              "b": {"c": rng.randn(4).astype(np.float32), "n": np.asarray(i, np.int32)}}
             for i in range(3)]
    for mine, theirs in ((ckpt.average_trees(trees), jckpt.average_trees(trees)),
                         (ckpt.ema_trees(trees, 0.7), jckpt.ema_trees(trees, 0.7))):
        a, b = _flat(mine), _flat(theirs)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        ckpt.ema_trees(trees, 1.0)
