"""The port's CLI, drivers and utils (counterpart of tests/test_cli.py), on
the CPU through `--device cpu`, against the JAX package where both run.

A LeNet at 16² on a temporary PNG tree: `fit --sanity-check` writes a
checkpoint; `load --testing` on a checkpoint the JAX CLI wrote gives the
JAX driver's subset scores, and the JAX driver gives the port's on one the
port wrote; `export` → `load_artifact(device="cpu")` serves the loaded
model's logits; `get_models_scores` resolves best > tuned on one version;
without `--device cpu` the command fails on the missing card.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from convnets_tpu import drivers as jax_drivers
from convnets_tpu import utils as jax_utils
from convnets_tpu.__main__ import main as jax_main
from convnets_tpu.data.manager import DataMngr as JaxDataMngr
from convnets_tpu_torch import drivers, utils
from convnets_tpu_torch.__main__ import main
from convnets_tpu_torch.data import CINIC_MEAN, CINIC_STD
from convnets_tpu_torch.data.manager import DataMngr
from convnets_tpu_torch.models import available_models, build_model
from convnets_tpu_torch.serve import load_artifact
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer
from convnets_tpu_torch.train import checkpoint as ckpt
from torch_one_thread import one_intra_op_thread  # noqa: F401

ARGS = ["--arch", "lenet", "--kind", "0", "--input-size", "3,16,16", "--num-classes", "2",
        "--batch-size", "8", "--no-mixed-precision"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.RandomState(0)
    for split in ("train", "valid", "test"):
        for cname in ("a", "b"):
            d = root / split / cname
            d.mkdir(parents=True)
            for i in range(8):
                arr = rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


def _fit(run, data_root, out, *extra):
    rc = run(["fit", *ARGS, "--data-root", data_root, "--epochs", "1", "--sanity-check",
              "--output-dir", str(out), *extra])
    assert rc == 0
    found = [f for f in os.listdir(out) if f.endswith(ckpt.EXT)]
    assert len(found) == 1
    return os.path.join(out, found[0])


@pytest.fixture(scope="module")
def port_ckpt(data_root, tmp_path_factory):
    return _fit(main, data_root, tmp_path_factory.mktemp("port_fit"), "--device", "cpu")


@pytest.fixture(scope="module")
def jax_ckpt(data_root, tmp_path_factory):
    return _fit(jax_main, data_root, tmp_path_factory.mktemp("jax_fit"))


def _setting(output_dir, **kw):
    return Settings(kind="0", input_size=(3, 16, 16), num_classes=2, batch_size=8,
                    mixed_precision=False, output_dir=str(output_dir), **kw)


def _jax_setting(output_dir):
    from convnets_tpu.settings import Settings as JaxSettings

    return JaxSettings(kind="0", input_size=(3, 16, 16), num_classes=2, batch_size=8,
                       mixed_precision=False, output_dir=str(output_dir))


def test_models_lists_the_ten_registered_names(capsys):
    assert main(["models"]) == 0
    out = capsys.readouterr().out.split()
    assert out == available_models() and len(out) == 16
    assert {"convnet", "lenet", "mynetwork", "vggnet", "squeezenet", "inceptionnet_v1",
            "resnet", "mobilenet_v1", "densenet", "resnext", "alexnet", "senet", "se_resnet",
            "shufflenet_v1", "sknet", "sk_resnet"} == set(out)


def test_fit_sanity_check_writes_a_checkpoint_and_plots(port_ckpt):
    out = os.path.dirname(port_ckpt)
    assert os.path.basename(port_ckpt).startswith("LeNet0-")
    _, meta = ckpt.load_checkpoint(port_ckpt)
    assert meta["extra"]["arch"] == "lenet" and meta["settings"]["input_size"] == [3, 16, 16]
    assert sorted(os.listdir(os.path.join(out, "plots"))) == [
        "confusion_test.png", "confusion_train.png", "confusion_valid.png", "performance.png"]


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_load_testing_gives_the_jax_subset_scores(written_by, data_root, port_ckpt, jax_ckpt,
                                                  tmp_path):
    """Each package's `process_load(..., testing=True)` on the same
    checkpoint (written by the JAX CLI, or by the port's) returns the same
    model name and subset scores: the checkpoint format, the bridge, the
    eval forward and the shuffled test order all agree."""
    path = jax_ckpt if written_by == "jax" else port_ckpt
    name, scores = drivers.process_load("lenet", _setting(tmp_path), path=path, testing=True,
                                        data_root=data_root, device="cpu")
    jname, jscores = jax_drivers.process_load("lenet", _jax_setting(tmp_path), path=path,
                                              testing=True, data_root=data_root)
    assert name == jname == "LeNet0"
    assert len(scores) == len(jscores) > 1
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-12)


def test_cli_load_testing_and_resume(data_root, port_ckpt, tmp_path):
    out = tmp_path / "resume"
    shutil.copytree(os.path.dirname(port_ckpt), out)
    assert main(["load", *ARGS, "--data-root", data_root, "--output-dir", str(out),
                 "--testing", "--device", "cpu"]) == 0
    assert main(["load", *ARGS, "--data-root", data_root, "--output-dir", str(out),
                 "--resume", "--epochs", "2", "--device", "cpu"]) == 0
    # --epochs on load --resume: that many more epochs after the checkpoint's one
    trainer, _ = drivers.process_load("lenet", _setting(out), path=port_ckpt,
                                      resume_training=True, epochs=2, data_root=data_root,
                                      device="cpu")
    assert len(trainer.epoch_results["train_loss"]) == 3
    assert trainer.epoch_results["total_epochs"] == 3


def test_export_serves_the_loaded_models_logits(data_root, port_ckpt, tmp_path):
    art = str(tmp_path / "lenet.bin")
    assert main(["export", *ARGS, "--data-root", data_root, "--output-dir",
                 os.path.dirname(port_ckpt), "--path", port_ckpt, "--out", art, "--bake-norm",
                 "--device", "cpu"]) == 0
    server = load_artifact(art, device="cpu")
    assert server.meta["normalization_baked"] and server.meta["class_names"] == ["a", "b"]
    trainer = Trainer(build_model("lenet", _setting(tmp_path), device="cpu"))
    trainer.load_checkpoint(port_ckpt)
    x = np.random.RandomState(3).rand(5, 16, 16, 3).astype(np.float32)
    norm = (x - np.asarray(CINIC_MEAN, np.float32)) / np.asarray(CINIC_STD, np.float32)
    with torch.inference_mode():
        want = trainer.model.eval()(torch.from_numpy(norm)).numpy()
    np.testing.assert_allclose(server(x).numpy(), want, atol=1e-5, rtol=1e-5)


def test_process_eval_without_matplotlib_skips_the_plots(data_root, port_ckpt, tmp_path,
                                                         monkeypatch, capsys):
    trainer = Trainer(build_model("lenet", _setting(tmp_path), device="cpu"))
    trainer.load_checkpoint(port_ckpt)
    data = DataMngr(trainer.setting, root=data_root, device="cpu")
    loaders = (data.load_train(), data.load_valid(), data.load_test())
    want = drivers.process_eval(trainer, *loaders, plot_dir=str(tmp_path / "with"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "convnets_tpu_torch.viz.plots", raising=False)
    capsys.readouterr()
    got = drivers.process_eval(trainer, *loaders, plot_dir=str(tmp_path / "without"))
    assert "plots skipped: matplotlib is not installed" in capsys.readouterr().out
    assert got[0] == want[0] and len(os.listdir(tmp_path / "with")) == 4
    assert not os.path.exists(tmp_path / "without")


def test_fit_without_device_cpu_names_the_missing_card(data_root, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device 'cuda' asked for, but no CUDA device"):
        main(["fit", *ARGS, "--data-root", data_root, "--output-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path) or not os.listdir(tmp_path)


def test_utils_split():
    parts = utils.split(list(range(10)), 4)
    assert parts == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]] == jax_utils.split(list(range(10)), 4)
    assert utils.split([], 4) == []


def test_utils_reproducible():
    utils.set_reproducible_mode(7)
    a, ta = np.random.rand(3), torch.rand(3)
    utils.set_reproducible_mode(7)
    b, tb = np.random.rand(3), torch.rand(3)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(ta, tb)
    jax_utils.set_reproducible_mode(7)
    np.testing.assert_array_equal(np.random.rand(3), a)


def test_get_models_scores_prefers_best_over_tuned(data_root, port_ckpt, tmp_path):
    """Two checkpoints of one model at one version, best_score and tuned
    (the tuned one with zeroed weights, so the two score differently):
    the best one is tested, in either package."""
    out = tmp_path / "scores"
    out.mkdir()
    best = str(out / os.path.basename(port_ckpt))
    shutil.copy(port_ckpt, best)
    trees, meta = ckpt.load_checkpoint(port_ckpt)
    zeroed = ckpt.unflatten_tree({k: np.zeros_like(v)
                                  for k, v in ckpt.flatten_tree(trees["params"]).items()})
    tuned = best.replace(ckpt.SUFFIX_BEST_SCORE, ckpt.SUFFIX_TUNED)
    ckpt.save_checkpoint(tuned, params=zeroed, model_state=trees["model_state"],
                         opt_state=trees["opt_state"], lr=trees["lr"],
                         loss_scale=trees["loss_scale"], epoch_results=meta["epoch_results"],
                         settings_dict=meta["settings"], scheduler_state=meta["scheduler"],
                         optimizer_name=meta["optimizer"], extra=meta["extra"])
    got = utils.get_models_scores(str(out), device="cpu",
                                  make_loader=lambda s: DataMngr(s, root=data_root,
                                                                 device="cpu").load_test())
    _, want = drivers.process_load("lenet", _setting(tmp_path), path=best, testing=True,
                                   data_root=data_root, device="cpu")
    _, zero = drivers.process_load("lenet", _setting(tmp_path), path=tuned, testing=True,
                                   data_root=data_root, device="cpu")
    assert list(got) == ["LeNet0"] and got["LeNet0"] == [float(s) for s in want]
    assert zero != want
    jgot = jax_utils.get_models_scores(str(out), make_loader=lambda s: JaxDataMngr(
        s, root=data_root).load_test())
    assert jgot == got
