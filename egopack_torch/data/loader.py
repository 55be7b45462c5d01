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

``WorkerPoolLoader`` (``loader_processes > 0``) builds whole batches in
worker processes, round-robin, and hands them over in the single-process
order, so the stream is the same bit for bit. Workers run numpy only: they
never touch CUDA, and batches stay numpy until ``DeviceCopier.put`` runs in
the consumer.

``device_batch`` and ``device_prefetch`` move the arrays the steps read
(``x``, ``y``, ``valid``) to the card from pinned host memory, by
non-blocking copies on a side stream, a few batches ahead of the step.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..io import native
from ..tracing import span
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
    ``prefetch > 0`` builds batches in a background thread.

    ``process_shard=(index, count)``: the global epoch schedule is computed
    alike on every rank and this one builds only block ``index`` of
    ``count`` equal blocks of every global batch; a block that holds no
    sample (the short last batch) is a batch of ``valid=False`` filler
    (egopack_tpu/data/loader.py:62-80)."""

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 0, prefetch: int = 4,
                 process_shard: Optional[tuple] = None):
        if process_shard is not None and batch_size % process_shard[1]:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{process_shard[1]} process shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.process_shard = process_shard
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

    def _produce(self, pass_idx: int,
                 stride: Optional[tuple] = None) -> Iterator[Dict[str, Any]]:
        """The batches of pass ``pass_idx``; ``stride=(w, W)`` yields only
        the batches ``k`` with ``k % W == w``, a worker's share. A batch's
        content does not depend on who builds it (the schedule is global and
        each sample's rng is keyed by its dataset index), so W strided
        producers interleave into the single-producer stream."""
        size = self.batch_size
        for k, idxs in enumerate(self._index_batches(pass_idx)):
            if stride is not None and k % stride[1] != stride[0]:
                continue
            if self.process_shard is not None:
                index, count = self.process_shard
                size = self.batch_size // count
                idxs = idxs[index * size:(index + 1) * size]
            if len(idxs) == 0:
                # every rank yields as many batches: this one is filler
                batch = collate([self.dataset.get(0, self._sample_rng(
                    pass_idx, 0))], pad_to=size)
                batch["valid"][:] = False
                yield batch
                continue
            samples = [self.dataset.get(int(i), self._sample_rng(pass_idx, i))
                       for i in idxs]
            yield collate(samples, pad_to=size)

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


_POOL_ERROR = "__worker_error__"


def _pool_worker(loader: DataLoader, wid: int, nworkers: int, cmd_q, out_q,
                 cur_gen) -> None:
    """A worker process: build this worker's round-robin share of each pass
    asked for, until the ``None`` sentinel. numpy only, never CUDA.

    Each batch travels as ``(gen, (batch, gathers))``: ``gathers`` are the
    feature gathers by path (``io.native.PATH_CALLS``) that this worker made
    since its last message, which the consumer adds to its own counts. When
    the consumer's generation ``cur_gen`` moves on (a multiloader
    wraparound abandoned the pass), the worker stops that pass. An error
    travels as ``(gen, (_POOL_ERROR, traceback))`` and ends the worker."""
    seen = dict(native.PATH_CALLS)

    def gathers() -> Dict[str, int]:
        now = dict(native.PATH_CALLS)
        delta = {k: now[k] - seen.get(k, 0) for k in now}
        seen.update(now)
        return delta

    while True:
        msg = cmd_q.get()
        if msg is None:
            return
        gen, epoch, pass_idx = msg
        loader._epoch = epoch
        try:
            for b in loader._produce(pass_idx, stride=(wid, nworkers)):
                out_q.put((gen, (b, gathers())))
                if cur_gen.value != gen:  # pass abandoned: next command
                    break
        except Exception:
            out_q.put((gen, (_POOL_ERROR, traceback.format_exc())))
            return


def _close_pool(procs, cmd_qs, out_qs, cur_gen) -> None:
    """Shut a worker pool down: mark any pass stale, send the sentinels,
    drain the queues so a worker blocked in ``put`` can finish and exit,
    terminate what is left after 5 s. Module-level so that
    ``weakref.finalize`` can hold it without keeping the loader alive."""
    cur_gen.value += 1
    for cq in cmd_qs:
        try:
            cq.put(None)
        except (ValueError, OSError):
            pass
    deadline = time.time() + 5.0
    while any(p.is_alive() for p in procs) and time.time() < deadline:
        for oq in out_qs:
            try:
                oq.get_nowait()
            except (queue.Empty, ValueError, OSError):
                pass
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(timeout=5)


class WorkerPoolLoader:
    """``DataLoader`` over N worker processes (the JAX package's
    ``WorkerPoolLoader``, egopack_tpu/data/loader.py:197-400): worker ``w``
    builds the whole batches ``k % N == w`` of each pass and the consumer
    reads the workers' queues in turn, so the stream equals the
    single-process one bit for bit.

    A pass that the consumer abandons (multiloader wraparound) is dropped
    by generation: the workers stop it when they see the next generation,
    and the consumer discards what they had queued. A worker's error, a
    worker that dies without one, and a worker silent for
    ``EGOPACK_POOL_STALL_S`` seconds (300 by default) raise in the
    consumer. ``EGOPACK_POOL_CTX`` picks the start method, ``fork`` by
    default (the datasets' memmaps are inherited); ``spawn`` pickles the
    dataset, whose feature store reopens its files by path in the child.
    Workers start at the first iteration and stop at :meth:`close`, or
    when the loader is collected."""

    # the consumer polls a queue this often, so a dead worker is seen soon
    GET_TIMEOUT_S = 5.0

    def __init__(self, loader: DataLoader, num_workers: int):
        if num_workers <= 0:
            raise ValueError(f"num_workers must be positive, got {num_workers}")
        self.loader = loader
        self.num_workers = num_workers
        self.stall_limit_s = float(os.environ.get("EGOPACK_POOL_STALL_S",
                                                  "300"))
        self._ctx = mp.get_context(os.environ.get("EGOPACK_POOL_CTX", "fork"))
        self._gen = 0
        self._cur_gen = self._ctx.Value("L", 0, lock=False)
        self._cmd_qs: list = []
        self._out_qs: list = []
        self._procs: list = []
        self._finalizer = None

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    @property
    def dataset(self) -> BaseDataset:
        return self.loader.dataset

    @property
    def process_shard(self) -> Optional[tuple]:
        return self.loader.process_shard

    def _start(self) -> None:
        for w in range(self.num_workers):
            cq = self._ctx.Queue()
            oq = self._ctx.Queue(maxsize=max(2, self.loader.prefetch))
            p = self._ctx.Process(
                target=_pool_worker,
                args=(self.loader, w, self.num_workers, cq, oq,
                      self._cur_gen), daemon=True)
            p.start()
            self._cmd_qs.append(cq)
            self._out_qs.append(oq)
            self._procs.append(p)
        self._finalizer = weakref.finalize(
            self, _close_pool, self._procs, self._cmd_qs, self._out_qs,
            self._cur_gen)

    def close(self) -> None:
        """Stop the workers; a later iteration starts new ones."""
        if self._finalizer is not None:
            self._finalizer()  # runs once, then detaches
            self._finalizer = None
        self._procs, self._cmd_qs, self._out_qs = [], [], []

    def _get(self, w: int, gen: int):
        """The next item of worker ``w``'s queue for generation ``gen``."""
        oq, p = self._out_qs[w], self._procs[w]
        waited = 0.0
        while True:
            try:
                g, item = oq.get(timeout=self.GET_TIMEOUT_S)
            except queue.Empty:
                if not p.is_alive():
                    raise RuntimeError(
                        f"loader worker {w} died (exitcode {p.exitcode}) "
                        "without reporting an error") from None
                waited += self.GET_TIMEOUT_S
                if waited >= self.stall_limit_s:
                    raise RuntimeError(
                        f"loader worker {w} produced nothing for "
                        f"{waited:.0f}s (EGOPACK_POOL_STALL_S="
                        f"{self.stall_limit_s:.0f}); if this is a "
                        "fork-inherited-lock deadlock, retry with "
                        "EGOPACK_POOL_CTX=spawn") from None
                continue
            if item[0] == _POOL_ERROR:
                raise RuntimeError(f"loader worker {w} failed:\n{item[1]}")
            batch, gathers = item
            for k, n in gathers.items():
                native.PATH_CALLS[k] = native.PATH_CALLS.get(k, 0) + n
            if g == gen:  # items of abandoned passes are dropped
                return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if not self._procs:
            self._start()
        pass_idx = self.loader._pass
        self.loader._pass += 1
        self._gen += 1
        gen = self._gen
        self._cur_gen.value = gen  # stops workers still on a stale pass
        for cq in self._cmd_qs:
            cq.put((gen, self.loader._epoch, pass_idx))
        for k in range(len(self.loader)):
            yield self._get(k % self.num_workers, gen)


Loader = Union[DataLoader, WorkerPoolLoader]


def build_dataloader(dataset: BaseDataset, batch_size: int, shuffle: bool,
                     num_workers: int, drop_last: bool, seed: int = 0,
                     worker_processes: int = 0,
                     process_shard: Optional[tuple] = None) -> Loader:
    """Signature-compatible with the reference builder; ``num_workers``
    sets the prefetch depth; ``worker_processes > 0`` builds the batches in
    that many worker processes (:class:`WorkerPoolLoader`), with the same
    stream; ``process_shard`` as for :class:`DataLoader`."""
    loader = DataLoader(dataset, batch_size, shuffle, drop_last, seed,
                        prefetch=max(2, num_workers),
                        process_shard=process_shard)
    if worker_processes > 0:
        return WorkerPoolLoader(loader, worker_processes)
    return loader


def close_loaders(dsets: Dict[str, Dict[str, Any]]) -> None:
    """Stop the worker pools of the drivers' loaders (``dl_train``,
    ``dl_val`` of each task); the in-process loaders have none."""
    for d in dsets.values():
        for key in ("dl_train", "dl_val"):
            dl = d.get(key)
            if hasattr(dl, "close"):
                dl.close()


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
        with span("egopack.h2d"):
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
