"""Host-side batching: dense collation, the multiloader schedule, prefetch
threads and host-to-device copies (the port's counterpart of
``egopack_tpu/data/loader.py``).

Collation stacks fixed-shape numpy samples into dense ``(B, N, S, D)``
arrays with a ``valid`` mask. The schedule is the JAX package's, so both
produce the same stream: the shuffle of each pass is drawn from
``default_rng((seed, epoch, pass))`` and each sample's augmentation rng is a
Philox generator keyed by its global dataset index. ``MultiLoader`` keeps
the reference's epoch (reference ``utils/dataloading.py:8-47``): as long as
the longest enabled loader, exhausted loaders restarting until all have
completed once.

``device_batch`` and ``device_prefetch`` move the arrays the steps read
(``x``, ``y``, ``valid``) to the card from pinned host memory, by
non-blocking copies on a side stream, a few batches ahead of the step.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .base import BaseDataset

_ARRAY_KEYS_PASSTHROUGH = ("uid", "clip_uid", "last_idx")
DEVICE_KEYS = ("x", "y", "valid")


def collate(samples: List[Dict[str, Any]],
            pad_to: Optional[int] = None) -> Dict[str, Any]:
    """Stack sample dicts; optionally right-pad to ``pad_to`` with the
    ``valid`` mask false on the padding (labels -1, features 0)."""
    batch: Dict[str, Any] = {}
    n = len(samples)
    size = pad_to or n
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in _ARRAY_KEYS_PASSTHROUGH:
            batch[key] = vals + [vals[-1]] * (size - n)
            continue
        arr = np.stack(vals)
        if size > n:
            pad = np.repeat(arr[-1:], size - n, axis=0)
            if np.issubdtype(arr.dtype, np.integer):
                pad = np.full_like(pad, -1)  # padded labels are ignored
            else:
                pad = np.zeros_like(pad)
            arr = np.concatenate([arr, pad], axis=0)
        batch[key] = arr
    valid = np.zeros(size, dtype=bool)
    valid[:n] = True
    batch["valid"] = valid
    return batch


class DataLoader:
    """Deterministic, re-iterable loader over a dense dataset (reference
    ``utils/dataloading.py:56-70``): seeded shuffle, ``drop_last`` for
    train; val pads its last partial batch and masks it with ``valid``.
    ``prefetch > 0`` builds batches in a background thread."""

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 0, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        self._pass = 0  # re-iteration counter within an epoch (wraparound)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._pass = 0

    def _index_batches(self, pass_idx: int) -> List[np.ndarray]:
        rng = np.random.default_rng((self.seed, self._epoch, pass_idx))
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _sample_rng(self, pass_idx: int, idx: int) -> np.random.Generator:
        """Augmentation rng keyed by the global dataset index: counter-based
        Philox with an explicit key (the JAX package's exact key)."""
        mix = (((self.seed * 1000003 + self._epoch) * 1000003 + pass_idx)
               & 0xFFFFFFFFFFFFFFFF)
        return np.random.Generator(np.random.Philox(key=[mix, int(idx)]))

    def _produce(self, pass_idx: int) -> Iterator[Dict[str, Any]]:
        for idxs in self._index_batches(pass_idx):
            samples = [self.dataset.get(int(i), self._sample_rng(pass_idx, i))
                       for i in idxs]
            yield collate(samples, pad_to=self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        # each re-iteration (multiloader wraparound) reshuffles and redraws
        # the augmentations, deterministically through (seed, epoch, pass)
        pass_idx = self._pass
        self._pass += 1
        if self.prefetch <= 0:
            yield from self._produce(pass_idx)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._produce(pass_idx):
                    if not put(b):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # an abandoned iterator (multiloader wraparound) must not leave
            # its worker blocked on a full queue: the worker sees the flag
            # within 0.1 s and ends (not joined here, which would stall the
            # consumer that long)
            stop.set()


def build_dataloader(dataset: BaseDataset, batch_size: int, shuffle: bool,
                     num_workers: int, drop_last: bool, seed: int = 0,
                     worker_processes: int = 0) -> DataLoader:
    """Signature-compatible with the reference builder; ``num_workers``
    sets the prefetch depth of the batch thread. Worker processes
    (``loader_processes > 0``, the JAX package's ``WorkerPoolLoader``) are
    not ported yet (ROADMAP, Queue 1 item 8)."""
    if worker_processes > 0:
        raise NotImplementedError(
            "loader_processes > 0 (WorkerPoolLoader) is not ported yet; see "
            "ROADMAP.md, Queue 1 item 8. Use loader_processes=0.")
    return DataLoader(dataset, batch_size, shuffle, drop_last, seed,
                      prefetch=max(2, num_workers))


class MultiLoader:
    """Zip N loaders; the epoch ends when ALL have been exhausted at least
    once. Exhausted loaders restart at once (wraparound); loaders with
    weight 0 (or None) yield ``None``."""

    def __init__(self, loaders: Sequence[Optional[DataLoader]],
                 weights: Sequence[float]):
        self.loaders = list(loaders)
        self.weights = list(weights)

    def __len__(self) -> int:
        active = [len(l) for l, w in zip(self.loaders, self.weights)
                  if l is not None and w > 0]
        return max(active) if active else 0

    def __iter__(self):
        iterators = [iter(l) if l is not None and w > 0 else None
                     for l, w in zip(self.loaders, self.weights)]
        completed = [it is None for it in iterators]
        while True:
            out = []
            for i, l in enumerate(self.loaders):
                if iterators[i] is None:
                    out.append(None)
                    continue
                try:
                    out.append(next(iterators[i]))
                except StopIteration:
                    completed[i] = True
                    if all(completed):
                        return
                    iterators[i] = iter(l)
                    try:
                        out.append(next(iterators[i]))
                    except StopIteration:
                        # a zero-batch loader ends the epoch, as the
                        # reference's propagated StopIteration does
                        return
            yield tuple(out)


multiloader = MultiLoader  # reference-compatible alias


class DeviceCopier:
    """Host batches to ``device``: the arrays the steps read (``x``, ``y``,
    ``valid``) as tensors.

    On the card each array is pinned and copied without blocking on a side
    stream, so copies overlap the running step. :meth:`ready` hands a batch
    to the consuming stream: that stream waits for the side stream, and
    every tensor records it, so the allocator does not reuse the memory
    while the consumer may still read it. On the CPU the tensors share the
    numpy arrays' memory."""

    def __init__(self, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self.dtype = dtype  # transfer dtype of x (None keeps float32)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _tensor(self, key: str, value: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(value))
        if key == "x" and self.dtype is not None:
            t = t.to(self.dtype)
        return t

    def put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        host = {k: self._tensor(k, v) for k, v in batch.items()
                if k in DEVICE_KEYS}
        if self.stream is None:
            return {k: t.to(self.device) for k, t in host.items()}
        with torch.cuda.stream(self.stream):
            return {k: t.pin_memory().to(self.device, non_blocking=True)
                    for k, t in host.items()}

    def ready(self, tree):
        """``tree`` (a batch dict, or a dict of them) for use on the
        current stream."""
        if self.stream is None:
            return tree
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        stack = [tree]
        while stack:
            node = stack.pop()
            for v in node.values():
                if isinstance(v, dict):
                    stack.append(v)
                else:
                    v.record_stream(current)
        return tree


def device_batch(batch: Dict[str, Any],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """One host batch's ``x``, ``y``, ``valid`` on ``device``, ready for
    the current stream."""
    copier = DeviceCopier(device)
    return copier.ready(copier.put(batch))


def device_prefetch(iterator, put, ready, depth: int = 2):
    """Stay ``depth`` transfers ahead of the consumer: ``put`` starts the
    copies of an item, ``ready`` hands it over when the consumer takes it
    (double buffering)."""
    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) >= depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())
