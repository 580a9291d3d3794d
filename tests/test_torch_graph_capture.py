"""StepGraph's capture (train/graph.py) on the CPU, with stand-ins for
torch.cuda's graph objects: a dead reference cycle left from earlier work
is collected before the capture begins, not by a collection that happens
to run during it (on the card, freeing an earlier CUDA graph and its
memory pool inside a capture invalidates the capture), and no collection
runs until the capture ends."""

import gc

import torch

from convnets_tpu_torch.train.graph import StepGraph

FREED = []


class _Cycle:
    """Unreachable as soon as it is made; only a collection frees it."""

    def __init__(self):
        self.me = self

    def __del__(self):
        FREED.append(True)


def test_dead_cycles_are_collected_before_the_capture(monkeypatch):
    seen = []

    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            pass

        def __enter__(self):
            seen.append((bool(FREED), gc.isenabled()))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    step = StepGraph("train", lambda x, y, w: (x.sum(), y.sum().float()), torch.zeros(4, 2),
                     torch.zeros(4, dtype=torch.int64), 2, 2)
    FREED.clear()
    gc.disable()
    try:
        _Cycle()
        assert not FREED
        step._capture()
        assert not gc.isenabled()  # the caller's setting is kept
    finally:
        gc.enable()
    step._capture()
    assert gc.isenabled()
    assert seen == [(True, False), (True, False)]
    assert step.graph is not None and step.per_replay is not None
