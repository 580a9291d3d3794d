"""The port's single-file serving artifact (serve/export.py) and the kernel
ops it traces (ops/kernels/library.py), on the CPU.

The JAX package's artifact and the port's are built from the same
variables (the JAX init with randomized BN, carried into the port by the
bridge) and serve the same uint8 requests; their logits agree within the
bar of tests/test_torch_resnet.py (TOL = 1e-4). One port artifact, with a
symbolic batch, serves batches 1, 3 and 8.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from convnets_tpu.models import build_model as jax_build_model
from convnets_tpu.serve import load_artifact as jax_load_artifact
from convnets_tpu.serve import save_artifact as jax_save_artifact
from convnets_tpu.settings import Settings
from convnets_tpu_torch import bridge
from convnets_tpu_torch.data import CINIC_MEAN, CINIC_STD
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops.kernels import library
from convnets_tpu_torch.serve import (
    ServingModel, export_trainer, load_artifact, read_artifact, save_artifact,
)
from convnets_tpu_torch.serve.export import MAGIC
from convnets_tpu_torch.train import Trainer
from torch_one_thread import one_intra_op_thread  # noqa: F401

TOL = 1e-4
STATS = (np.array([0.49, 0.48, 0.45], np.float32), np.array([0.25, 0.24, 0.26], np.float32))
HERE = os.path.dirname(os.path.abspath(__file__))


def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _jax_model():
    setting = Settings(kind="18", input_size=(3, 32, 32), num_classes=10,
                       mixed_precision=False)
    jm = jax_build_model("resnet", setting)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.RandomState(18)
    return setting, jm, {"params": _randomize_bn(variables["params"], rng),
                         "state": _randomize_bn(variables["state"], rng)}


def _port(output_dir=None):
    setting, _, variables = _jax_model()
    if output_dir is not None:
        setting = Settings(**{**setting.to_dict(), "output_dir": str(output_dir)})
    model = build_model("resnet", setting, device="cpu")
    bridge.load_jax_variables(model, variables)
    return model


def _requests(n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The port's and the JAX package's uint8-wire, baked-normalization,
    symbolic-batch artifacts of the same variables, the port's metadata, and
    the port's artifact loaded on the CPU."""
    d = tmp_path_factory.mktemp("artifacts")
    _, jm, variables = _jax_model()
    mine, theirs = str(d / "port.bin"), str(d / "jax.bin")
    meta = save_artifact(mine, _port(), stats=STATS, input_dtype="uint8",
                         class_names=[f"c{i}" for i in range(10)])
    jax_save_artifact(theirs, jm, variables, stats=STATS, input_dtype="uint8",
                      platforms=("cpu",))
    return mine, theirs, meta, load_artifact(mine, device="cpu")


def test_artifact_matches_the_jax_artifact(artifacts):
    _, theirs, _, served = artifacts
    x = _requests(3)
    want = np.asarray(jax_load_artifact(theirs)(x))
    got = served(x)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_one_artifact_serves_every_batch(artifacts, batch):
    """The symbolic batch: one file, batches 1, 3 and 8, each equal to the
    live ServingModel's logits."""
    served = artifacts[3]
    live = ServingModel(_port(), stats=STATS, input_dtype="uint8")
    x = _requests(batch, seed=batch)
    got = served(x)
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), live(x).numpy(), atol=TOL, rtol=TOL)
    assert served.predict(x[0]) == [f"c{int(got[0].argmax())}"]


def test_metadata_has_the_jax_keys_the_input_contract_and_the_checksum(artifacts):
    _, jm, _ = _jax_model()
    meta = artifacts[2]
    from convnets_tpu.serve.export import _metadata as jax_metadata

    want = jax_metadata(jm, output="logits", batch_size=None, platforms=["cpu"], stats=STATS,
                        input_dtype="uint8", class_names=[f"c{i}" for i in range(10)])
    port_only = {"torch_version", "input_contract", "payload_bytes", "payload_sha256"}
    assert set(meta) - port_only == set(want) - {"jax_version"}
    assert all(meta[k] == want[k] for k in set(want) - {"jax_version"})
    assert meta["input_contract"] == {"layout": "NHWC", "dtype": "uint8", "range": [0, 255],
                                      "data_norm": True, "normalization_baked": True,
                                      "host_normalization": None}
    assert read_artifact(artifacts[0])[0] == meta
    # trained with data_norm, not baked: the host must normalize, with what
    unbaked = ServingModel(_port(), input_dtype="float32").meta["input_contract"]
    assert unbaked["host_normalization"] == {"mean": [float(v) for v in CINIC_MEAN],
                                             "std": [float(v) for v in CINIC_STD]}
    assert not unbaked["normalization_baked"] and unbaked["range"] == [0.0, 1.0]


def _corrupt(src, dst, cut=None, flip=None, magic=None):
    data = bytearray(open(src, "rb").read())
    if flip is not None:
        data[flip] ^= 0x01
    if magic is not None:
        data[:len(MAGIC)] = magic
    with open(dst, "wb") as f:
        f.write(bytes(data[:cut]))
    return dst


def test_a_broken_file_raises_value_error_naming_it(artifacts, tmp_path):
    src = artifacts[0]
    size = os.path.getsize(src)
    meta_len = int.from_bytes(open(src, "rb").read()[len(MAGIC):len(MAGIC) + 4], "little")
    header = len(MAGIC) + 4
    cases = {
        "short header": dict(cut=len(MAGIC) + 2),
        "short metadata": dict(cut=header + meta_len // 2),
        "no payload": dict(cut=header + meta_len),
        "short payload": dict(cut=size - 100),
        "one flipped byte": dict(flip=size - 12345),
        "bad magic": dict(magic=b"CONVNETS_TPU_EXPORT\x00XX"),
    }
    for name, kw in cases.items():
        path = _corrupt(src, str(tmp_path / f"{name}.bin"), **kw)
        with pytest.raises(ValueError, match=re.escape(path)):
            load_artifact(path, device="cpu")


def test_a_request_of_another_dtype_raises_type_error(artifacts):
    served = artifacts[3]
    for bad in (_requests(2).astype(np.float32) / 255, _requests(2).astype(np.int64)):
        with pytest.raises(TypeError):
            served(bad)


def test_load_artifact_needs_a_card_unless_told(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_artifact(artifacts[0])


def test_export_trainer_from_a_checkpoint_serves_probs(tmp_path):
    """fit's checkpoint format: save, load into a Trainer over a fresh
    model, export probabilities with the normalization baked and a float32
    wire; they are the JAX forward's softmax."""
    _, jm, variables = _jax_model()
    trainer = Trainer(_port(tmp_path))
    trainer.init_state()  # fresh weights from the seed: the JAX ones go back in
    bridge.load_jax_variables(trainer.model, variables)
    ckpt = trainer.save_checkpoint()
    assert ckpt.endswith(".ckpt.npz")
    setting = Settings(**{**_jax_model()[0].to_dict(), "output_dir": str(tmp_path), "seed": 7})
    fresh = Trainer(build_model("resnet", setting, device="cpu"))
    fresh.load_checkpoint(ckpt)
    path = str(tmp_path / "probs.bin")
    meta = export_trainer(fresh, path, output="probs", stats=STATS)
    assert meta["output"] == "probs" and meta["input_dtype"] == "float32"
    x = np.random.RandomState(5).rand(4, 32, 32, 3).astype(np.float32)
    got = load_artifact(path, device="cpu")(x).numpy()
    logits, _ = jm.apply(variables, (x - STATS[0]) / STATS[1], train=False)
    np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(logits, axis=-1)), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_a_fresh_process_serves_without_the_model_code(artifacts):
    code = ("import sys, numpy as np\n"
            "from convnets_tpu_torch.serve import load_artifact\n"
            f"served = load_artifact({artifacts[0]!r}, device='cpu')\n"
            "x = np.zeros((2, 32, 32, 3), np.uint8)\n"
            "assert served(x).shape == (2, 10)\n"
            "assert 'convnets_tpu_torch.models' not in sys.modules\n"
            "assert not any(m.startswith('convnets_tpu.') for m in sys.modules)\n"
            "print('served')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(HERE), timeout=300)
    assert out.returncode == 0 and "served" in out.stdout, out.stderr


def _op_args():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 9, 9, 8).astype(np.float32))
    w = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    return {
        "conv2d_fused": [(x, w(3, 3, 8, 16), w(16), w(16), [2, 2], [1, 1], True),
                         (x.bfloat16(), w(1, 1, 8, 4).bfloat16(), None, None, [1, 1], [0, 0],
                          False)],
        "grouped_conv2d_fused": [(x, w(3, 3, 4, 16), 2, w(16), w(16), [1, 1], [1, 1], True)],
        "depthwise_conv2d": [(x, w(3, 3, 1, 8), [2, 2], [1, 1])],
        "max_pool2d": [(x, [3, 3], [2, 2], [1, 1])],
        "avg_pool2d": [(x, [2, 2], [2, 2], [0, 0])],
        "winograd_conv2d": [(x, w(3, 3, 8, 16), w(16), None, None, [1, 1], False, 4),
                            (x.bfloat16(), w(3, 3, 8, 4).bfloat16(), None, w(4), w(4), [0, 0],
                             True, 2)],
    }


def _winograd_plain(a):
    from convnets_tpu_torch.ops import winograd

    x, w, b, scale, shift, padding, relu, m = a
    return winograd.conv2d_winograd_plain(x, w, b, padding=padding, m=m, scale=scale,
                                          shift=shift, relu=relu)


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck_each_op(name):
    """torch.library.opcheck: schema, fake tensor against the CPU
    implementation, autograd registration, aot dispatch with dynamic
    shapes; and each op computes its wrapper's plain version."""
    from convnets_tpu_torch.ops import kernels

    op = getattr(torch.ops, library.NAMESPACE)
    for args in _op_args()[name]:
        torch.library.opcheck(getattr(op, name), args)
        got = getattr(op, name)(*args)
        plain = {"conv2d_fused": lambda a: kernels.conv2d_fused_plain(
                     *a[:4], stride=a[4], padding=a[5], relu=a[6]),
                 "grouped_conv2d_fused": lambda a: kernels.grouped_conv2d_fused_plain(
                     *a[:5], stride=a[5], padding=a[6], relu=a[7]),
                 "depthwise_conv2d": lambda a: kernels.depthwise_conv2d_plain(
                     *a[:2], stride=a[2], padding=a[3]),
                 "max_pool2d": lambda a: kernels.max_pool2d_plain(*a),
                 "avg_pool2d": lambda a: kernels.avg_pool2d_plain(*a),
                 "winograd_conv2d": _winograd_plain}[name](args)
        assert torch.equal(got, plain)
