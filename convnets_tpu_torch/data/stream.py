"""ShardRotationLoader: a split larger than the device's share for it,
rotated through the device in chunks (counterpart of
convnets_tpu/data/stream.py).

  * the split is decoded once into a uint8 disk cache (ImageFolderDataset's
    memmap build), so an epoch reads rows at memcpy speed;
  * each epoch draws one global permutation (DataLoader's seeded
    `_epoch_indices`), cut into chunks of `batches_per_chunk` batches; a
    thread gathers each chunk's rows into pinned host memory;
  * the chunks rotate through the device double-buffered: chunk c + 1
    goes to a staging buffer on a side stream while chunk c's steps run,
    and is then copied into the one static chunk buffer that the Trainer's
    captured step reads (train/graph.py); events order the copies and the
    steps, so the host never waits for the device. At most two chunks are
    on the device: the static one and the staging one;
  * the batches index the chunk in order, and step s of chunk c is the
    epoch's step c·batches_per_chunk + s, so the epoch equals a
    DeviceCacheLoader epoch over the same permutation.

Under data parallel each rank rotates its own disjoint rows: its host
slice of the epoch's permutation (host_id, num_hosts), cut into chunks of
one geometry on every rank (as convnets_tpu/data/stream.py:125-140 gives
each process its block of the global chunk).

Every chunk has one shape. The last one's free rows replay index 0 of the
split at weight 0, as DeviceCacheLoader pads its last batch, and its
batches that hold no example are not run. (The JAX package runs them, at
weight 0, so its chunked epoch takes extra steps where the batch count is
not a multiple of batches_per_chunk.)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from convnets_tpu_torch.data.datasets import Dataset
from convnets_tpu_torch.data.loader import DataLoader


@dataclass
class Chunk:
    """One chunk on the device: the static chunk buffer, its batches'
    chunk-local (batches_per_chunk, bs) index and weight matrices, the
    chunk's labels on the host, and where its batches stand in the epoch."""
    data: torch.Tensor  # (chunk_images, H, W, C), the static chunk buffer
    labels: torch.Tensor  # (chunk_images,) int32
    idx_mat: np.ndarray  # (batches_per_chunk, bs) int32, chunk-local
    w_mat: np.ndarray  # (batches_per_chunk, bs) float32 0/1
    host_labels: np.ndarray  # (chunk_images,)
    first_step: int  # the epoch's index of the chunk's first batch
    num_steps: int  # the chunk's batches that hold an example


class ShardRotationLoader:
    """Iterates a split as a rotation of device-resident chunks.

    DataLoader's sizing, permutation, seed and per-host contract;
    `epoch_chunks()` is what the Trainer's chunked epoch reads (one call
    per epoch), `__iter__` the per-step routes' host batches (debug,
    sanity_check, BN re-estimation, the timed test loop), zero-padded as
    DataLoader pads them."""

    # the chunk budget: two chunks on the device must leave room for the
    # parameters, optimizer state and activations
    DEFAULT_CHUNK_BYTES = 2 << 30

    def __init__(self, dataset: Dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, host_id: int = 0, num_hosts: int = 1,
                 chunk_bytes: Optional[int] = None, device="cuda"):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.epoch = 0
        self.chunk_bytes = int(chunk_bytes or self.DEFAULT_CHUNK_BYTES)
        self.device = torch.device(device)
        # the Trainer's routing flags: a replayed epoch, chunk by chunk
        self.scan_epochs = True
        self.chunked = True
        self._buffers = None

    # the same sizing and permutation rules as DataLoader
    __len__ = DataLoader.__len__
    num_examples = DataLoader.num_examples
    _host_count = DataLoader._host_count
    _epoch_indices = DataLoader._epoch_indices

    def _plan(self) -> Tuple[int, int, int]:
        """(batches in the epoch, batches per chunk, chunks) for this
        host's share; every chunk holds batches_per_chunk batches."""
        bs = self.batch_size
        n = self._host_count()
        nb_total = max(n // bs if self.drop_last else -(-n // bs), 1)
        bpc = max(1, self.chunk_bytes // (bs * int(np.prod(self.dataset.image_shape))))
        return nb_total, min(bpc, nb_total), -(-nb_total // bpc)

    @property
    def num_chunks(self) -> int:
        return self._plan()[2]

    def _chunk_buffers(self, cimg: int, image_shape, dtype):
        """The static chunk buffer and, on the card, the staging buffer on
        the device and two pinned host buffers, made once per shape."""
        key = (cimg, tuple(image_shape), dtype)
        if self._buffers is None or self._buffers[0] != key:
            cuda = self.device.type == "cuda"

            def pair(device, pin=False):
                return (torch.empty((cimg, *image_shape), dtype=dtype, device=device,
                                    pin_memory=pin),
                        torch.empty((cimg,), dtype=torch.int32, device=device, pin_memory=pin))

            self._buffers = (key, {
                "static": pair(self.device),
                "staging": pair(self.device) if cuda else None,
                "host": [pair("cpu", cuda), pair("cpu", cuda)],
                "stream": torch.cuda.Stream(self.device) if cuda else None})
        return self._buffers[1]

    def epoch_chunks(self) -> Iterator[Chunk]:
        """One epoch as a sequence of equal-shape chunks in the static
        buffer, each ready on the current stream when it is yielded. A
        thread gathers chunk c + 2 into a pinned buffer and a side stream
        sends chunk c + 1 to the staging buffer while the caller queues
        chunk c's steps."""
        order = self._epoch_indices()
        self.epoch += 1
        nb_total, bpc, num_chunks = self._plan()
        bs = self.batch_size
        cimg = bpc * bs
        load = getattr(self.dataset, "load_raw", None) or self.dataset.load
        real = min(len(order), nb_total * bs)
        rows = np.zeros((num_chunks * cimg,), np.int64)  # free rows replay index 0
        rows[:real] = order[:real]
        w_all = np.zeros((num_chunks * cimg,), np.float32)
        w_all[:real] = 1.0
        idx_mat = np.arange(cimg, dtype=np.int32).reshape(bpc, bs)
        x0, _ = load(rows[:1])
        buf = self._chunk_buffers(cimg, x0.shape[1:], torch.from_numpy(x0).dtype)
        static, staging, host, side = buf["static"], buf["staging"], buf["host"], buf["stream"]
        cuda = side is not None

        def gather(ci: int, slot: int) -> np.ndarray:
            x, y = load(rows[ci * cimg:(ci + 1) * cimg])
            host[slot][0].numpy()[...] = x
            host[slot][1].numpy()[...] = y
            return np.asarray(y)

        def chunk(ci: int, host_labels: np.ndarray) -> Chunk:
            return Chunk(static[0], static[1], idx_mat, w_all[ci * cimg:(ci + 1) * cimg]
                         .reshape(bpc, bs), host_labels, ci * bpc, min(bpc, nb_total - ci * bpc))

        with ThreadPoolExecutor(1, thread_name_prefix="chunk-gather") as pool:
            if not cuda:
                for ci in range(num_chunks):
                    y = gather(ci, 0)
                    static[0].copy_(host[0][0])
                    static[1].copy_(host[0][1])
                    yield chunk(ci, y)
                return
            current = torch.cuda.current_stream(self.device)
            sent = [torch.cuda.Event(), torch.cuda.Event()]  # a pinned slot's copy ended
            copied = torch.cuda.Event()  # the staging buffer's copy into static ended

            def send(ci: int) -> None:
                slot = ci % 2
                side.wait_event(copied)
                with torch.cuda.stream(side):
                    staging[0].copy_(host[slot][0], non_blocking=True)
                    staging[1].copy_(host[slot][1], non_blocking=True)
                sent[slot].record(side)

            labels = [gather(0, 0), None]
            send(0)
            pending = pool.submit(gather, 1, 1) if num_chunks > 1 else None
            for ci in range(num_chunks):
                slot = ci % 2
                current.wait_event(sent[slot])
                static[0].copy_(staging[0])
                static[1].copy_(staging[1])
                copied.record(current)
                if ci + 1 < num_chunks:
                    labels[1 - slot] = pending.result()
                    send(ci + 1)
                    if ci + 2 < num_chunks:
                        sent[slot].synchronize()  # chunk c's pinned slot is read: refill it
                        pending = pool.submit(gather, ci + 2, slot)
                yield chunk(ci, labels[slot])

    def __iter__(self):
        """The per-step routes' host batches: DataLoader's permutation and
        zero padding, rows gathered from the dataset."""
        order = self._epoch_indices()
        self.epoch += 1
        bs = self.batch_size
        nb = len(order) // bs if self.drop_last else -(-len(order) // bs)
        load = getattr(self.dataset, "load_raw", None) or self.dataset.load
        for bi in range(nb):
            idx = order[bi * bs:(bi + 1) * bs]
            x, y = load(idx)
            k = len(idx)
            if k < bs:
                x = np.concatenate([x, np.zeros((bs - k, *x.shape[1:]), x.dtype)])
                y = np.concatenate([y, np.zeros((bs - k,), y.dtype)])
            w = np.zeros((bs,), np.float32)
            w[:k] = 1.0
            yield x, y, w
