"""Host data pipeline: deterministic batching with worker processes, and
prefetch onto the card (counterpart of ``eegan_tpu/data/pipeline.py``).

* per-sample RNG is ``Philox(seed, epoch, index)`` (``np.random.default_rng
  ([seed, epoch, index])``) and the epoch's shuffle ``default_rng([seed,
  epoch])``, as in the JAX package, so the port draws the JAX package's
  batches bit for bit, and a resumed run reads what an uninterrupted one
  would;
* decoding runs in a process pool (JPEG decode + resize is the only
  CPU-heavy part). The pool starts with ``spawn`` at the first epoch that
  needs it: the trainer's process has CUDA and threads running by then,
  and a worker never touches ``torch.cuda``;
* :func:`device_prefetch` puts batches on the card ahead of use: pinned
  host memory, copies on a side CUDA stream, an event the consumer's
  stream waits on. The length leaves stay on the host (pinned), because
  the packed LSTM reads them there (``training/steps.py``).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

# Leaves the train step reads on the host (pack_padded_sequence lengths).
LENGTH_KEYS = frozenset({"cap_lens", "unpair_cap_lens", "attr_lens"})

_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_sample(args):
    seed, epoch, index = args
    rng = np.random.default_rng([seed, epoch, index])
    return _WORKER_DATASET.sample(index, rng)


def _stack(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, (str, bytes)):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class DataPipeline:
    """Epoch-based shuffled batching over a dataset with `.sample(i, rng)`."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 0, shuffle: bool = True,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1):
        """``batch_size`` is GLOBAL; a process loads rows
        [process_index * local, (process_index + 1) * local) of each batch,
        local = batch_size / process_count (the JAX package's multi-host
        split; one process in the port so far)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if process_count > 1 and not drop_last:
            raise ValueError("multi-host runs require drop_last=True "
                             "(per-host batch slicing assumes full batches)")
        self.local_batch = batch_size // process_count
        self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _workers(self):
        if self._pool is None and self.num_workers > 0:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, epoch]).shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:limit]

        use_batch = (hasattr(self.dataset, "sample_batch")
                     and getattr(self.dataset, "_decoded", None) is not None)
        lo = self.process_index * self.local_batch
        hi = lo + self.local_batch
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size][lo:hi]
            if use_batch:
                # zero-IPC fast path: one native OpenMP call per batch
                rngs = [np.random.default_rng([self.seed, epoch, int(i)])
                        for i in idxs]
                yield self.dataset.sample_batch([int(i) for i in idxs], rngs)
                continue
            args = [(self.seed, epoch, int(i)) for i in idxs]
            pool = self._workers()
            if pool is not None:
                samples = pool.map(_worker_sample, args)
            else:
                _worker_init(self.dataset)
                samples = [_worker_sample(a) for a in args]
            yield _stack(samples)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


def group_batches(iterator: Iterator[Dict[str, np.ndarray]],
                  k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Stack consecutive batches into (K, B, ...) leaves for the K-step
    driver (`make_multi_train_step`). The epoch tail yields a smaller
    stack."""
    group = []
    for batch in iterator:
        group.append(batch)
        if len(group) == k:
            yield {key: np.stack([b[key] for b in group]) for key in group[0]}
            group = []
    if group:
        yield {key: np.stack([b[key] for b in group]) for key in group[0]}


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], device,
                    depth: int = 2) -> Iterator[Dict]:
    """Batches on ``device``, up to ``depth`` of them copied ahead of use.

    On a CUDA device a thread takes the host batches, pins them, and copies
    every array leaf but the lengths (:data:`LENGTH_KEYS`, which stay in
    pinned host memory) on a side stream; the consumer's stream waits on an
    event recorded after the copies, and each device tensor is marked as
    used on that stream (``record_stream``), so the caching allocator keeps
    its memory until the consumer's work is done. A failure in the host
    pipeline is raised to the consumer. On the CPU the batches pass
    through unchanged.
    """
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return

    side = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def put(batch):
        out = {}
        with torch.cuda.stream(side):
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = (host if k in LENGTH_KEYS
                          else host.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def producer():
        try:
            for batch in iterator:
                if not offer(put(batch)):
                    return
        except BaseException as e:  # handed to the consumer, which raises
            offer(e)
        finally:
            offer(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for v in out.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(stream)
            yield out
    finally:
        stop.set()
