"""Rank bodies of tests/test_torch_parallel*.py: each runs in a process of
its own (convnets_tpu_torch.parallel.dryrun.run_ranks), imports torch and
the port and never jax, joins a gloo group through the file:// URL it is
given, and writes what it computed to <workdir>/rank<r>.npz for the test to
hold against its references. Not a test module: pytest collects nothing
here."""

import os

import numpy as np
import torch
import torch.distributed as dist

from convnets_tpu_torch import bridge
from convnets_tpu_torch.data import ArrayDataset, DataLoader, DeviceCacheLoader
from convnets_tpu_torch.models import build_model
from convnets_tpu_torch.ops.kernels import conv_bn_relu_train
from convnets_tpu_torch.ops.norm import batch_norm_train, batch_stats, bn_apply_stats
from convnets_tpu_torch.parallel import init_distributed, make_mesh, mesh_scope, shard_batch
from convnets_tpu_torch.settings import Settings
from convnets_tpu_torch.train import Trainer


def _join(rank, world, init):
    init_distributed(init, world, rank, device="cpu")
    torch.set_num_threads(2)
    return make_mesh()


def _save(payload, rank, out):
    np.savez(os.path.join(payload["workdir"], f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def bn_functions(rank, world, init, payload):
    """The BN functions on this rank's block of the global inputs under the
    mesh: outputs, statistics, dx and this rank's parameter gradients."""
    mesh = _join(rank, world, init)
    g = np.load(payload["inputs"])
    out = {}

    def leaf(a, grad=False):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

    x, gy = (leaf(a) for a in shard_batch(mesh, (g["x"], g["gy"])))
    x.requires_grad_(True)
    w, scale, bias = leaf(g["w"], True), leaf(g["scale"], True), leaf(g["bias"], True)
    with mesh_scope(mesh):
        y, mean, var = conv_bn_relu_train(x, w, scale, bias, 1, 1)
        dx, dw, ds, db = torch.autograd.grad(y, (x, w, scale, bias), gy)
        out.update(fused_y=y, fused_mean=mean, fused_var=var, fused_dx=dx, fused_dw=dw,
                   fused_dscale=ds, fused_dbias=db)

        h, gh = (leaf(a) for a in shard_batch(mesh, (g["h"], g["gh"])))
        h.requires_grad_(True)
        z, rm, rv = batch_norm_train(h, leaf(g["rm"]), leaf(g["rv"]), scale, bias)
        dh, ds, db = torch.autograd.grad(z, (h, scale, bias), gh)
        out.update(core_y=z, core_rm=rm, core_rv=rv, core_dx=dh, core_dscale=ds, core_dbias=db)

        m, v = batch_stats(h.detach())
        z = bn_apply_stats(h, m, v, scale, bias)
        dh, ds, db = torch.autograd.grad(z, (h, scale, bias), gh)
        out.update(stats_mean=m, stats_var=v, apply_y=z, apply_dx=dh, apply_dscale=ds,
                   apply_dbias=db)
    _save(payload, rank, {k: t.detach().numpy() for k, t in out.items()})
    dist.destroy_process_group()


def _trainer(mesh, payload, **kw):
    setting = Settings(**{**payload["setting"], **kw})
    model = build_model(payload["arch"], setting, device="cpu")
    if "variables" in payload:
        bridge.load_jax_variables(model, _tree(dict(np.load(payload["variables"]))))
    trainer = Trainer(model, mesh=mesh)
    trainer._new_state()
    return trainer


def _steps(trainer, mesh, batches, out, prefix):
    """The trainer's step over this rank's block of each global batch;
    the losses summed over the ranks, then every variable."""
    step = trainer._get_train_step(augment=False, norm=True)
    losses = []
    for x, y, w in batches:
        x, y, w = (torch.from_numpy(a) for a in shard_batch(mesh, (x, y, w)))
        loss, _ = step(trainer.state, x, y.long(), w)
        dist.all_reduce(loss)
        losses.append(float(loss))
    out[f"{prefix}losses"] = np.asarray(losses)
    for coll, tree in bridge.export_jax_variables(trainer.model).items():
        for k, v in _flat(tree).items():
            out[f"{prefix}{coll}/{k}"] = v


def train_steps(rank, world, init, payload):
    """Trainer steps over this rank's block of each global batch, for every
    settings variant in payload["variants"]."""
    mesh = _join(rank, world, init)
    data = np.load(payload["batches"])
    batches = [(data[f"x{i}"], data[f"y{i}"], data[f"w{i}"]) for i in range(payload["steps"])]
    out = {}
    for name, kw in payload["variants"].items():
        _steps(_trainer(mesh, payload, **kw), mesh, batches, out, f"{name}/")
    _save(payload, rank, out)
    dist.destroy_process_group()


def draws_and_route(rank, world, init, payload):
    """One epoch of a dropout + mixup fit over this rank's slice of a
    DeviceCacheLoader under the gloo mesh: its route, every dropout mask,
    mixup permutation and λ the steps drew, and the epoch's metrics."""
    from convnets_tpu_torch import ops
    from convnets_tpu_torch.train import engine

    mesh = _join(rank, world, init)
    trainer = _trainer(mesh, payload)
    d = np.load(payload["data"])
    loader = DeviceCacheLoader(ArrayDataset(d["images"], d["labels"]), payload["batch"],
                               shuffle=True, seed=1, host_id=rank, num_hosts=world,
                               device="cpu")
    loader.augment, loader.normalize = False, True
    masks, perms, lams = [], [], []
    mask_fn, perm_fn, run = ops.dropout_mask, engine.mixup_perm, engine.TrainStep._run

    def recording_mask(x, rate, generator):
        m = mask_fn(x, rate, generator)
        masks.append(m.numpy().reshape(-1))
        return m

    def recording_perm(generator, n):
        p = perm_fn(generator, n)
        perms.append(p.numpy())
        return p

    def recording_run(self, state, *a):
        lams.append(float(state.scalars.lam))
        return run(self, state, *a)

    ops.dropout_mask, engine.mixup_perm, engine.TrainStep._run = (recording_mask, recording_perm,
                                                                  recording_run)
    scans = trainer._use_epoch_scan(loader)
    loss, score = trainer._run_train_epoch(loader, 0)
    valid = trainer._run_eval_epoch(DataLoader(ArrayDataset(d["images"], d["labels"]),
                                               payload["batch"], host_id=rank, num_hosts=world))
    _save(payload, rank, {"scans": scans, "graphs": len(trainer._epoch_fns),
                          "masks": np.concatenate(masks), "perms": np.stack(perms),
                          "lams": np.asarray(lams), "metrics": np.asarray([loss, score, *valid]),
                          "n_steps": len(lams)})
    dist.destroy_process_group()


def fail_on_rank_one(rank, world, init, payload):
    """Rank 1 fails after the rendezvous; rank 0 waits in a collective that
    never completes, so only the launcher's stop ends it."""
    _join(rank, world, init)
    if rank == 1:
        raise SystemExit(3)
    dist.barrier()
