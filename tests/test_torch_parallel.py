"""The port's data parallel (convnets_tpu_torch/parallel) on the CPU: gloo
ranks in subprocesses (tests/torch_parallel_ranks.py, which import torch
and the port and never jax; each run stopped at RANK_TIMEOUT seconds).

* Against JAX: the JAX Trainer's step on a 2-device CPU mesh (GSPMD:
  the batch sharded, sync-BN, the gradient all-reduce) against the port's
  Trainer on 2 gloo ranks, each stepping its block of the same global
  batch, from the same numpy-drawn weights: RN18@16, global batch 8, SGD
  at lr 1e-3, fp32, 2 steps, held to tests/test_distributed.py's bars
  (losses rtol 2e-5, parameters rtol 2e-4 / atol 1e-6) and the BN running
  statistics to the same; the two ranks' variables bit for bit. (RN18@16
  normalizes its last stages over the 8 values of a 1x1 map: at a third
  step, or at lr 1e-2, the JAX Trainer on 1 device and on 2 devices part
  by 18x those bars themselves; after 2 steps at lr 1e-3 they agree within
  0.41 of them, and the port in one process within 0.52.)
* The optimizer options under 2 ranks (loss_reduction "mean", Adam, the
  global-norm clip) against the port in one process at the global batch.
* The random draws and the route: under a gloo mesh a DeviceCacheLoader
  epoch runs per step (no CUDA graph captures gloo's collectives); the
  dropout masks and mixup permutations differ between the ranks, mixup's
  λ is the same on both, and both read the same epoch metrics.
* dryrun_multichip(2, "cpu"); the mesh helpers in a world of one; the
  Trainer without a process group.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.parallel import data_sharding as jdata_sharding
from convnets_tpu.parallel import make_mesh as jmake_mesh
from convnets_tpu.parallel import replicated as jreplicated
from convnets_tpu.settings import Settings as JSettings
from convnets_tpu.train import Trainer as JTrainer
from convnets_tpu.train.state import create_train_state as jcreate_train_state
from convnets_tpu_torch import bridge
from convnets_tpu_torch.core.rng import generator_for
from convnets_tpu_torch.data.augment import mixup_lambda
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.parallel import (
    data_rank, data_size, init_distributed, make_mesh, mesh_scope, shard_batch,
)
from convnets_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from convnets_tpu_torch.parallel.mesh import data_mean_, data_sum_, global_count
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer

from test_torch_zoo_attention import numpy_variables
from torch_parallel_ranks import _flat
from torch_one_thread import one_intra_op_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT = 120
WORLD, GLOBAL_BATCH, STEPS = 2, 8, 2
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 1e-6  # tests/test_distributed.py
SETTING = dict(kind="18", input_size=(3, 16, 16), num_classes=10, batch_size=GLOBAL_BATCH // WORLD,
               mixed_precision=False, data_augment=False, data_norm=True, dropout_rate=0.0,
               optimizer="sgd", learning_rate=1e-3, seed=0)
VARIANTS = {"mean": {"loss_reduction": "mean"},
            "adam": {"optimizer": "adam", "learning_rate": 1e-4},
            "clip": {"grad_clip_norm": True, "gc_max_norm": 0.5}}
# (rtol, atol) of each variant's variables against one process; Adam's
# g/sqrt(v) turns reduction-order noise at near-zero gradients into whole
# steps, so its parameters are held to tests/test_torch_train.py's Adam bar
VARIANT_TOL = {"mean": (PARAM_RTOL, PARAM_ATOL), "clip": (PARAM_RTOL, PARAM_ATOL),
               "adam": (1e-3, 1e-3)}


def _batches():
    rng = np.random.RandomState(7)
    return [(rng.randint(0, 256, (GLOBAL_BATCH, 16, 16, 3)).astype(np.uint8),
             rng.randint(0, 10, GLOBAL_BATCH).astype(np.int32),
             np.ones(GLOBAL_BATCH, np.float32)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(variables, npz of their flat leaves, npz of the batches)."""
    tmp = tmp_path_factory.mktemp("weights")
    jm = jax_build_model("resnet", JSettings(**{**SETTING, "batch_size": GLOBAL_BATCH}))
    variables = numpy_variables(jax.eval_shape(jm.init, jax.random.key(0)), 3)
    np.savez(tmp / "variables.npz", **_flat(variables))
    np.savez(tmp / "batches.npz", **{f"{k}{i}": a for i, b in enumerate(_batches())
                                     for k, a in zip("xyw", b)})
    return variables, str(tmp / "variables.npz"), str(tmp / "batches.npz")


@pytest.fixture(scope="module")
def spawned(weights, tmp_path_factory):
    """The module's two rank runs, started together in the background (the
    tests that read them overlap their own work with the ranks'): the
    steps (plain SGD, against JAX, and the VARIANTS) and the draws."""
    _, variables, batches = weights
    steps, draws = tmp_path_factory.mktemp("steps"), tmp_path_factory.mktemp("draws")
    rng = np.random.RandomState(3)
    np.savez(draws / "data.npz", images=rng.randint(0, 256, (32, 16, 16, 3)).astype(np.uint8),
             labels=rng.randint(0, 10, 32).astype(np.int32))
    jobs = {"steps": (steps, "torch_parallel_ranks:train_steps",
                      {"arch": "resnet", "setting": SETTING, "variables": variables,
                       "batches": batches, "steps": STEPS, "workdir": str(steps),
                       "variants": {"sgd": {}, **VARIANTS}}),
            "draws": (draws, "torch_parallel_ranks:draws_and_route",
                      {"arch": "resnet", "setting": {**SETTING, "dropout_rate": 0.5, "mixup": 0.2},
                       "data": str(draws / "data.npz"), "batch": 4, "workdir": str(draws)})}

    def run(tmp, target, payload):
        run_ranks(target, WORLD, payload, workdir=str(tmp), timeout=RANK_TIMEOUT, paths=[HERE])
        return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]

    with ThreadPoolExecutor(len(jobs)) as pool:
        yield {name: pool.submit(run, *job) for name, job in jobs.items()}


@pytest.fixture(scope="module")
def rank_steps(spawned):
    return spawned["steps"].result()


@pytest.fixture(scope="module")
def draws(spawned):
    return spawned["draws"].result()


def _jax_steps(variables):
    """The JAX Trainer's step on a 2-device mesh over the global batches."""
    setting = JSettings(**{**SETTING, "batch_size": GLOBAL_BATCH})
    mesh = jmake_mesh(jax.devices()[:WORLD])
    trainer = JTrainer(jax_build_model("resnet", setting), mesh=mesh)
    trainer.state = jax.device_put(jcreate_train_state(variables, setting, "sgd"),
                                   jreplicated(mesh))
    step = trainer._get_train_step(augment=False, norm=True)
    ds = jdata_sharding(mesh)
    state, losses = trainer.state, []
    for i, batch in enumerate(_batches()):
        x, y, w = (jax.device_put(jnp.asarray(a), ds) for a in batch)
        state, loss, _ = step(state, x, y, w, jax.random.key(i))
        losses.append(float(loss))
    return losses, {"params": jax.tree.map(np.asarray, state.params),
                    "state": jax.tree.map(np.asarray, state.model_state)}


def _port_steps(variables, **kw):
    """The port in one process, no mesh, over the global batches."""
    model = build_model("resnet", Settings(**{**SETTING, **kw, "batch_size": GLOBAL_BATCH}),
                        device="cpu")
    bridge.load_jax_variables(model, variables)
    trainer = Trainer(model)
    trainer._new_state()
    step = trainer._get_train_step(augment=False, norm=True)
    losses = []
    for x, y, w in _batches():
        loss, _ = step(trainer.state, torch.from_numpy(x), torch.from_numpy(y).long(),
                       torch.from_numpy(w))
        losses.append(float(loss))
    return losses, bridge.export_jax_variables(model)


def _hold(rank0, prefix, losses, variables, loss_rtol, rtol, atol):
    np.testing.assert_allclose(rank0[f"{prefix}losses"], losses, rtol=loss_rtol)
    want = {f"{c}/{k}": v for c in ("params", "state") for k, v in _flat(variables[c]).items()}
    got = {k[len(prefix):]: v for k, v in rank0.items()
           if k.startswith(prefix) and k != f"{prefix}losses"}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_two_ranks_match_the_jax_trainer_on_a_two_device_mesh(weights, spawned):
    variables, _, _ = weights
    losses, final = _jax_steps(variables)
    _hold(spawned["steps"].result()[0], "sgd/", losses, final, LOSS_RTOL, PARAM_RTOL,
          PARAM_ATOL)


@pytest.mark.parametrize("variant", ["sgd", *VARIANTS])
def test_ranks_hold_bit_identical_replicas(rank_steps, variant):
    a, b = rank_steps
    keys = [k for k in a if k.startswith(f"{variant}/")]
    assert keys and all(np.array_equal(a[k], b[k]) for k in keys)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_optimizer_options_match_one_process_at_the_global_batch(weights, rank_steps, variant):
    variables, _, _ = weights
    losses, final = _port_steps(variables, **VARIANTS[variant])
    _hold(rank_steps[0], f"{variant}/", losses, final, LOSS_RTOL, *VARIANT_TOL[variant])


def test_gloo_mesh_takes_the_per_step_route(draws):
    """A DeviceCacheLoader offers the replayed epoch; under a gloo mesh the
    Trainer declines it (`_use_epoch_scan`) and captures no graph."""
    for r in draws:
        assert not bool(r["scans"]) and int(r["graphs"]) == 0 and int(r["n_steps"]) == 4


def test_ranks_draw_their_own_masks_and_share_lambda(draws):
    a, b = draws
    assert a["masks"].shape == b["masks"].shape and a["masks"].size > 0
    assert (a["masks"] != b["masks"]).mean() > 0.3  # two independent p=0.5 draws part ~half
    assert any(not np.array_equal(p, q) for p, q in zip(a["perms"], b["perms"]))
    np.testing.assert_array_equal(a["lams"], b["lams"])
    # λ of step (0, s) is the host's draw at (e, s), as in one process
    want = [float(torch.tensor(mixup_lambda(generator_for(0, "mixup", 0, s), 0.2),
                               dtype=torch.float32)) for s in range(len(a["lams"]))]
    np.testing.assert_array_equal(a["lams"], np.asarray(want, np.float32))
    np.testing.assert_array_equal(a["metrics"], b["metrics"])


def test_dryrun_multichip_on_cpu(capsys):
    line = dryrun_multichip(WORLD, "cpu", timeout=RANK_TIMEOUT)
    assert line.startswith(f"dryrun_multichip({WORLD}):") and line.endswith("OK")
    assert line in capsys.readouterr().out


def test_a_rank_that_fails_stops_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        run_ranks("torch_parallel_ranks:fail_on_rank_one", WORLD, {}, workdir=str(tmp_path),
                  timeout=RANK_TIMEOUT, paths=[HERE])


def test_trainer_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    model = build_model("lenet", Settings(kind=0, input_size=(3, 16, 16), num_classes=4),
                        device="cpu")
    for kw in ({"use_mesh": True}, {"mesh": object()}):
        with pytest.raises(RuntimeError, match="init_distributed"):
            Trainer(model, **kw)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_mesh_helpers_in_a_world_of_one():
    """init_distributed with no arguments outside torchrun forms a world of
    one; the mesh names its axes as the JAX package does, shard_batch's
    block is the whole batch, and the sums are the identity."""
    assert init_distributed(device="cpu") == (0, 1, 1)
    try:
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data",) and data_size(mesh) == 1 and data_rank(mesh) == 0
        assert make_mesh(mesh_shape=(1, 1)).mesh_dim_names == ("axis0", "data")
        x = np.arange(12).reshape(6, 2)
        (block,) = shard_batch(mesh, (x,))
        np.testing.assert_array_equal(block, x)
        t = torch.tensor([1.5, -2.0])
        with mesh_scope(mesh):
            assert data_sum_(t, 7) == 7 and global_count(7) == 7
            assert torch.equal(data_mean_(t), torch.tensor([1.5, -2.0]))
        assert global_count(7) == 7
    finally:
        torch.distributed.destroy_process_group()
