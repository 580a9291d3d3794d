"""Training over whole epochs, as `fit()` runs them: the window calls the
Trainer's epoch (`Trainer._run_train_epoch`, the call `fit()` makes each
epoch) until its seconds have passed. The traffic file sets the loader
("device_cache": a DeviceCacheLoader holding the split on the card;
"shard_rotation": a ShardRotationLoader rotating a host split through the
card in chunks of `chunk_bytes`), the batch, the split's size and the
shuffle. Both loaders replay one captured step per batch. A traced run
profiles the window's second epoch.

Set-up builds the model, loads the benchmark's weights through
`load_state_dict`, makes the split, and runs the first epoch (epoch 0)
through the same call: its first steps are the ones `check` follows. The
port runs two steps eagerly and replays the capture from the third on
(`train/graph.py` StepGraph), so the check reads one step of each kind.
The reference follows the three steps from the benchmark's weights: the
first step's gradient and BN statistics, and the parameters' change over
the three, are compared with it. The third step (REPLAYED, the capture's
replay) is compared with the reference's step from the program's own
state before it, so that the two trajectories' drift (Adam's first steps
move each weight by about lr times the sign of its gradient, which
round-off flips) stays out of it; the change over the three steps covers
what that skips. A hook on the train step's host part (`prepare`, which
runs before every step, replayed or not) copies what the check needs:
Adam's first moment after steps 1, 2 and 3 (the gradient Adam got at step
t is (m_t - b1 m_(t-1)) / (1 - b1)), the BN statistics after each, every
tensor before the third step, and the parameters and the step losses
after it.
"""

from __future__ import annotations

import gc
import time

import torch

import judge
import slices
import streams
import weights
from reference import resnet as ref

CHECK_STEPS = 3
REPLAYED = 2  # the step (from 0) that the port runs as the capture's replay


class Mix:
    def __init__(self, ctx):
        self.cfg, self.traffic = ctx["cfg"], ctx["traffic"]
        self.seed, self.device = ctx["seed"], torch.device(ctx["device"])
        self.batch = int(self.traffic["batch"])
        self.n = int(self.traffic["images"])
        self.loader_seed = self.seed % (2 ** 31)
        self.snap = {}
        self._batches = None  # the check's batches, made once

    # ------------------------------------------------------------------
    # set-up

    def make_loader(self):
        from convnets_tpu_torch.data.datasets import ArrayDataset
        images, labels = weights.make_split(self.n, self.cfg, self.seed, self.device)
        dataset = ArrayDataset(images.cpu().numpy(), labels.cpu().numpy())
        del images, labels
        kind = self.traffic["loader"]
        if kind == "device_cache":
            from convnets_tpu_torch.data.loader import DeviceCacheLoader
            loader = DeviceCacheLoader(dataset, self.batch, shuffle=self.traffic["shuffle"],
                                       seed=self.loader_seed, device=self.device)
        elif kind == "shard_rotation":
            from convnets_tpu_torch.data.stream import ShardRotationLoader
            loader = ShardRotationLoader(dataset, self.batch, shuffle=self.traffic["shuffle"],
                                         seed=self.loader_seed,
                                         chunk_bytes=int(self.traffic["chunk_bytes"]),
                                         device=self.device)
        else:
            raise ValueError(f"unknown loader {kind!r}")
        return loader

    def _hook(self, step):
        """Wrap the train step's host part to copy the state the check
        follows (the module's docstring)."""
        original, trainer = step.prepare, self.trainer
        names = {v: k for k, v in weights.port_names(self.cfg).items()}
        b1 = self.cfg["optimizer"]["b1"]
        calls, grads, stats = [0], {}, []
        self.snap.update(grads=grads, stats=stats)

        def host(tensors):
            return {names[k]: weights.from_port(t).to("cpu", torch.float32, copy=True)
                    for k, t in tensors.items()}

        def prepare(state, rng=None):
            done = calls[0]  # steps finished before this one
            if 1 <= done <= CHECK_STEPS:
                stats.append(host({k: t for k, t in trainer.model.state_dict().items()
                                   if ref.is_buffer(names[k])}))
            if done == 1:
                grads[0] = {k: m / (1.0 - b1) for k, m in host(state.opt_state.mu).items()}
            elif done == REPLAYED:
                self.snap["mu"] = host(state.opt_state.mu)
                self.snap["before_replayed"] = host(trainer.model.state_dict())
            elif done == REPLAYED + 1:
                graph = next(g for g in trainer._epoch_fns.values() if g.kind == "train")
                if graph.cuda and graph.graph is None:
                    raise RuntimeError(f"step {REPLAYED} ran eagerly: the check reads it "
                                       "as the capture's replay")
                before = self.snap.pop("mu")
                grads[REPLAYED] = {k: (m - b1 * before[k]) / (1.0 - b1)
                                   for k, m in host(state.opt_state.mu).items()}
            if done == CHECK_STEPS:
                graph = next(g for g in trainer._epoch_fns.values() if g.kind == "train")
                self.snap["losses"] = graph.outputs[0][:CHECK_STEPS].double().cpu().numpy()
                self.snap["after"] = host(trainer.model.state_dict())
            calls[0] += 1
            return original(state, rng)

        step.prepare = prepare

    def setup(self):
        from convnets_tpu_torch.train.engine import Trainer
        self.model = weights.port_model(self.cfg, self.seed, self.device, self.batch)
        self.loader = self.make_loader()
        trainer = self.trainer = Trainer(self.model)
        # fit()'s preamble: a fresh state over the loaded weights, the
        # scheduler, and the learning rate the step reads
        trainer._new_state()
        trainer.init_optimizer()
        trainer.state.lr = float(trainer.scheduler.lr)
        augment, norm = trainer._resolve_flags(self.loader, train=True)
        step = trainer._get_train_step(augment, norm, False, trainer._resolve_stats(self.loader))
        self._hook(step)
        with slices.host_range("train_epoch"):
            trainer._run_train_epoch(self.loader, 0)
        self.epoch = 1
        if "after" not in self.snap:
            raise RuntimeError("the first epoch ran fewer than "
                               f"{CHECK_STEPS + 1} steps: nothing to check")
        self.steps_per_epoch = -(-self.n // self.batch)

    # ------------------------------------------------------------------
    # the window

    def _epoch(self):
        with slices.host_range("train_epoch"):
            self.trainer._run_train_epoch(self.loader, self.epoch)
        self.epoch += 1

    def window(self, seconds: float, profile: bool):
        """Whole epochs until `seconds` have passed; with `profile`, the
        window's second epoch under the profiler. Returns (metrics,
        attempted, slice or None)."""
        done, sl, t0 = 0, None, time.perf_counter()
        while True:
            if profile and done == 1:
                with slices.Profiled() as p:
                    p.mark_start()
                    self._epoch()
                    p.mark_end()
                sl = p.reduce(steps=self.steps_per_epoch, images=self.n)
            else:
                self._epoch()
            done += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (not profile or sl is not None):
                break
        metrics = {"train_img_s": (done * self.n / elapsed, "img/s")}
        return metrics, done * self.steps_per_epoch, sl

    def release(self):
        self.trainer.close()
        del self.trainer, self.model, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the check

    def check_batches(self, images, labels):
        """The first CHECK_STEPS batches of epoch 0 as the reference gets
        them: rows from the loader's permutation rule, keep masks from the
        dropout rule, both worked out here."""
        order = (streams.epoch_order(self.n, self.loader_seed, 0) if self.traffic["shuffle"]
                 else range(self.n))
        width = ref.head_in(self.cfg)
        out = []
        for s in range(CHECK_STEPS):
            rows = torch.as_tensor(list(order[s * self.batch:(s + 1) * self.batch]),
                                   device=self.device)
            keep = streams.dropout_keep((self.batch, width), self.cfg["dropout_rate"],
                                        self.seed, 0, s, self.device)
            out.append((images[rows], labels[rows], keep))
        return out

    def reference(self, precision="fp32", half_batch=False, control=False):
        """The reference's three steps from the benchmark's weights at
        `precision` (with the half-batch fault where asked), and the
        tensors before them. `grads` holds the first step's gradient, and
        for a `control` (which stands in for the program) the third's too,
        and `states` every tensor before the third step."""
        start = weights.make_tensors(self.cfg, self.seed, self.device)
        batches = self.batches()
        out = ref.train_steps(self.cfg, self.lr, start, batches, precision=precision,
                              half_batch=half_batch, grads_at=(0, REPLAYED) if control else (0,),
                              states_at=(REPLAYED,) if control else ())
        return self._host(out), self._host(start)

    def batches(self):
        if self._batches is None:
            images, labels = weights.make_split(self.n, self.cfg, self.seed, self.device)
            self._batches = self.check_batches(images, labels)
        return self._batches

    @property
    def lr(self):
        return self.cfg["assumed"]["learning_rate"]

    def replayed_reference(self, state):
        """The float32 reference's step REPLAYED from `state` (every tensor
        of the side being judged before that step)."""
        state = {k: v.to(self.device) for k, v in state.items()}
        out = ref.train_steps(self.cfg, self.lr, state, self.batches()[REPLAYED:REPLAYED + 1])
        return self._host(out)

    @staticmethod
    def _host(out):
        """Every tensor of a reference's output (or a dict of tensors) on the host."""
        if isinstance(out, torch.Tensor):
            return out.cpu()
        if isinstance(out, dict):
            return {k: Mix._host(v) for k, v in out.items()}
        if isinstance(out, list):
            return [Mix._host(v) for v in out]
        return out

    def numbers(self, detail=False):
        ref_out, start = self.reference()
        replayed = self.replayed_reference(self.snap["before_replayed"])
        return self._judge(self.snap, ref_out, replayed, start, detail)

    def control_numbers(self, precision="fp8", half_batch=False, detail=False):
        """The reference put in the program's place: at `precision`, or with
        the half-batch fault, judged against the float32 reference."""
        ref_out, start = self.reference()
        ctl, _ = self.reference(precision=precision, half_batch=half_batch, control=True)
        replayed = self.replayed_reference(ctl["states"][REPLAYED])
        return self._judge(ctl, ref_out, replayed, start, detail)

    @staticmethod
    def _judge(prog, ref_out, replayed, start, detail):
        """The compared numbers; with `detail` also the uncompared loss gaps,
        both sides' losses and the leaves with the largest gradient gaps
        (calibrate.py prints them)."""
        numbers = judge.train_numbers(prog, ref_out, replayed, start, REPLAYED)
        if not detail:
            return numbers
        return numbers, {
            **judge.loss_gaps(prog["losses"], ref_out["losses"]),
            "losses": [list(map(float, prog["losses"])), list(map(float, ref_out["losses"]))],
            "grad_worst": [judge.worst_leaves(judge.norms(prog["grads"][0]),
                                              judge.norms(ref_out["grads"][0])),
                           judge.worst_leaves(judge.norms(prog["grads"][REPLAYED]),
                                              judge.norms(replayed["grads"][0]))],
        }
