"""Multi-rank dry run (counterpart of __graft_entry__.py:dryrun_multichip)
and the rank launcher it runs on.

    python -m convnets_tpu_torch.parallel.dryrun 2 cpu     # gloo ranks on the CPU
    python -m convnets_tpu_torch.parallel.dryrun 2 cuda    # ranks on the card(s)

`dryrun_multichip(n, device)` starts n rank processes (`run_ranks`). Each
joins one process group through a file in a fresh directory (no TCP port
to pick): gloo on the CPU; on the card NCCL where every rank has a card of
its own, else gloo over ranks that share a card (NCCL refuses two ranks on
one device). Each rank takes one full sharded train step on RN18@32 (its
block of a global batch of 2·n: forward, backward with the BN statistics
reduced over the ranks, the summed gradient, Adam, the BN running
statistics), then one epoch over its slice of a DeviceCacheLoader, and
checks that its parameters and buffers equal rank 0's bit for bit. A rank
that fails, or a run that outlasts its time limit, stops every rank and
raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD = """
import importlib, json, sys
sys.path[:0] = json.loads(sys.argv[1])
module, name = sys.argv[2].split(":")
getattr(importlib.import_module(module), name)(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                                               json.loads(sys.argv[6]))
"""


def run_ranks(target: str, world: int, payload: Optional[dict] = None, *,
              workdir: Optional[str] = None, timeout: float = 120.0,
              paths: Optional[List[str]] = None, threads: int = 2) -> List[str]:
    """Run `target` ("module:function", called as fn(rank, world,
    init_method, payload)) in `world` fresh Python processes, and return
    each rank's output (stdout and stderr). init_method is a file:// URL in
    `workdir` (a new temporary directory by default) for
    init_distributed's coordinator. `paths` go first on the children's
    sys.path (the repository root is always there). A rank that exits
    non-zero stops the others, and the call raises RuntimeError with its
    output; at `timeout` seconds every rank is stopped and the call raises
    TimeoutError."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own else workdir
    init = "file://" + os.path.join(os.path.abspath(workdir), f"rendezvous-{time.time_ns()}")
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), GLOO_SOCKET_IFNAME="lo")
    env.pop("WORLD_SIZE", None)
    logs, procs = [], []
    try:
        for rank in range(world):
            logs.append(open(os.path.join(workdir, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, json.dumps([_ROOT, *(paths or [])]), target,
                 str(rank), str(world), init, json.dumps(payload or {})],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=_ROOT, env=env))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
        if own:
            for name in os.listdir(workdir):
                os.remove(os.path.join(workdir, name))
            os.rmdir(workdir)
    if failed == "timeout":
        raise TimeoutError(f"{target}: {world} ranks outlasted {timeout} s\n"
                           + "\n".join(f"--- rank {r}\n{o}" for r, o in enumerate(outputs)))
    if failed is not None:
        raise RuntimeError(f"{target}: rank {failed} of {world} exited "
                           f"{procs[failed].returncode}\n{outputs[failed]}")
    return outputs


def _rank_body(rank: int, world: int, init: str, payload: dict) -> None:
    """One rank of dryrun_multichip."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from convnets_tpu_torch.core.rng import generator_for
    from convnets_tpu_torch.data import DeviceCacheLoader, synthetic_dataset
    from convnets_tpu_torch.models import build_model
    from convnets_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_batch
    from convnets_tpu_torch.settings import Settings
    from convnets_tpu_torch.train import Trainer
    from convnets_tpu_torch.train.engine import data_rng

    device = payload["device"]
    init_distributed(init, world, rank, device=device, backend=payload["backend"])
    torch.set_num_threads(2)
    mesh = make_mesh()
    batch = 2 * world
    setting = Settings(kind="18", input_size=(3, 32, 32), num_classes=10, batch_size=2,
                       mixed_precision=device != "cpu", data_augment=True, data_norm=True,
                       output_dir=payload["output_dir"])
    trainer = Trainer(build_model("resnet", setting, device=device), mesh=mesh)
    trainer.init_state()
    trainer.init_optimizer()
    step = trainer._get_train_step(augment=True, norm=True)
    g = np.random.RandomState(0)
    x, y = shard_batch(mesh, (g.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8),
                              g.randint(0, 10, batch).astype(np.int32)))
    loss, correct = step(trainer.state, x, y, None,
                         generator_for(0, "dropout", 0, 0, rank, device=device),
                         data_rng(0, device, 0, 0, rank=rank))
    total = torch.stack([loss.float(), correct.float()]).reshape(2)
    dist.all_reduce(total)
    ds = synthetic_dataset(2 * batch, (32, 32, 3), 10, seed=0)
    loader = DeviceCacheLoader(ds, 2, shuffle=True, host_id=rank, num_hosts=world, device=device)
    loader.augment, loader.normalize = True, True
    epoch_loss, _ = trainer._run_train_epoch(loader, 1)
    # every rank's parameters and buffers equal rank 0's, bit for bit
    same = torch.ones(1, device=device)
    for t in trainer.model.state_dict().values():
        mine = t.detach().float().reshape(-1)
        ref = mine.clone()
        dist.broadcast(ref, src=0)
        same *= torch.equal(mine, ref)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if same.item() != 1.0:
        raise RuntimeError(f"rank {rank}: the replicas differ after the step and the epoch")
    if rank == 0:
        print(f"dryrun_multichip({world}): {dist.get_backend()} on {device}, global batch "
              f"{batch}: step loss={float(total[0]):.4f} correct={float(total[1]):.0f}; "
              f"epoch over {len(loader)} steps loss={epoch_loss:.4f}; replicas equal OK",
              flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cpu", timeout: float = 300.0) -> str:
    """Run the dry run over n ranks on `device` ("cpu" or "cuda"); print
    and return rank 0's line (`dryrun_multichip(n): ... OK`). Raises if a
    rank fails."""
    import torch

    cuda = device != "cpu"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip({n}, {device!r}): no CUDA device")
    backend = "nccl" if cuda and torch.cuda.device_count() >= n else "gloo"
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        outputs = run_ranks("convnets_tpu_torch.parallel.dryrun:_rank_body", n,
                            {"device": device, "backend": backend, "output_dir": tmp},
                            workdir=tmp, timeout=timeout)
    line = next((ln for ln in outputs[0].splitlines()
                 if ln.startswith(f"dryrun_multichip({n})") and ln.endswith("OK")), None)
    if line is None:
        raise RuntimeError(f"dryrun_multichip({n}): rank 0 printed no OK line\n{outputs[0]}")
    print(line)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "cpu")
