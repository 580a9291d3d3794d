"""Batch scoring by one closed-loop client: it sends a request, waits until
its logits are on the host, and sends the next. A request is a pageable
numpy uint8 array of NHWC images, as a scoring job holds it; its latency
runs from the call until its logits are a host array. The traffic file
sets the batch, the pool of seeded request batches the client cycles
through, and how many served requests the check compares.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

import judge
import slices
import weights
from reference import resnet as ref

PROFILED = 100  # requests in a traced run's profiled slice


class Mix:
    def __init__(self, ctx):
        self.cfg, self.traffic = ctx["cfg"], ctx["traffic"]
        self.seed, self.device = ctx["seed"], torch.device(ctx["device"])
        self.batch = int(self.traffic["batch"])
        self.pool_size = int(self.traffic["pool"])

    def make_pool(self):
        """The request batches on the device, from the seed."""
        images, _ = weights.make_split(self.pool_size * self.batch, self.cfg, self.seed + 2,
                                       self.device)
        return images.view(self.pool_size, self.batch, *images.shape[1:])

    def setup(self):
        from convnets_tpu_torch.serve.export import ServingModel
        model = self.model = weights.port_model(self.cfg, self.seed, self.device, self.batch)
        self.serving = ServingModel(model, input_dtype="uint8")
        self.requests = [r.cpu().numpy() for r in self.make_pool()]
        for r in self.requests[:2]:  # the one request shape, warmed
            self.serving(r).cpu()
        self.sampler = random.Random(self.seed)
        self.sample = []  # (request index, logits) of a reservoir drawn from the seed
        self.sent = 0

    def _request(self, latencies):
        i = self.sent
        t0 = time.perf_counter()
        with slices.host_range("serve_request"):
            logits = self.serving(self.requests[i % self.pool_size]).cpu().numpy()
        latencies.append(time.perf_counter() - t0)
        k = int(self.traffic["sample"])
        if len(self.sample) < k:
            self.sample.append((i, logits))
        else:
            j = self.sampler.randrange(i + 1)
            if j < k:
                self.sample[j] = (i, logits)
        self.sent += 1

    def window(self, seconds: float, profile: bool):
        """Requests until `seconds` have passed; with `profile`, the
        PROFILED requests of them, after the first 20, under the
        profiler. Returns (metrics, attempted, slice or None)."""
        lat, sl, t0 = [], None, time.perf_counter()
        while True:
            if profile and sl is None and len(lat) == 20:
                with slices.Profiled() as p:
                    p.mark_start()
                    for _ in range(PROFILED):
                        self._request(lat)
                    p.mark_end()
                sl = p.reduce(steps=PROFILED, images=PROFILED * self.batch)
            else:
                self._request(lat)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (not profile or sl is not None):
                break
        ms = 1e3 * np.asarray(lat)
        metrics = {"serve_img_s": (len(lat) * self.batch / elapsed, "img/s"),
                   "serve_p95_ms": (float(np.percentile(ms, 95)), "ms")}
        return metrics, len(lat), sl

    def release(self):
        del self.serving, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, precision="fp32", used=None):
        """The reference's logits of the pool batches `used` (all by default)."""
        tensors = weights.make_tensors(self.cfg, self.seed, self.device)
        pool = self.make_pool()
        used = range(self.pool_size) if used is None else used
        return {b: ref.eval_logits(self.cfg, tensors, pool[b], precision=precision).cpu()
                for b in used}

    def numbers(self):
        refs = self.reference_logits(used=sorted({i % self.pool_size for i, _ in self.sample}))
        return {"logit_gap": max(judge.logit_gap(torch.from_numpy(lg), refs[i % self.pool_size])
                                 for i, lg in self.sample)}

    def control_numbers(self, precision="fp8"):
        refs = self.reference_logits()
        ctl = self.reference_logits(precision)
        return {"logit_gap": max(judge.logit_gap(ctl[b], refs[b]) for b in refs)}
