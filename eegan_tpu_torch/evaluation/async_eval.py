"""Evaluation overlapped with training (counterpart of
``eegan_tpu/evaluation/async_eval.py``).

A background thread takes each generator snapshot the trainer submits,
generates ``eval_nums`` images and scores FID (against dataset statistics)
and optionally R-precision, while the training loop keeps stepping. On the
card the thread works on a CUDA stream of its own, so its kernels
interleave with the training stream's; the host-side work (Gaussian
statistics, sqrtm) stays off the training thread.

The optimizer updates the parameters in place (JAX's hazard was buffer
donation), so :meth:`AsyncEvaluator.submit` clones the snapshot on the
caller's (training) stream and records an event there; the evaluation
stream waits on that event before it reads the clones.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import queue
import threading
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from eegan_tpu_torch.models.factory import ModelBundle

Tensors = Dict[str, torch.Tensor]


def eval_bundle(models: ModelBundle, shards=None) -> ModelBundle:
    """The bundle an AsyncEvaluator's Tester runs: copies of the generator
    and AttrEnhance (each snapshot is loaded into them, never into the
    modules that train) beside the same frozen encoders. Under FSDP
    (``shards``: the train state's ``FsdpShards``, whose modules are
    empty at rest) the copies get full-size parameters."""
    if shards is None:
        gen, attr = (copy.deepcopy(models.generator),
                     copy.deepcopy(models.attr_enhance))
    else:
        gen, attr = (shards.generator.unsharded_copy(),
                     shards.attr_enhance.unsharded_copy())
    return dataclasses.replace(models, generator=gen, attr_enhance=attr)


class AsyncEvaluator:
    """Background FID (and R-precision) evaluation of generator snapshots.

    tester: an ``evaluation.tester.Tester`` over :func:`eval_bundle`'s
        modules (generation and the encoders).
    real_stats: a mu/sigma ``.npz`` or a folder of real images; without
        it FID is skipped. The FID network has random weights from a seed,
        as the JAX package's does (relative comparisons only).
    """

    def __init__(self, tester, writer=None, real_stats: Optional[str] = None,
                 eval_nums: int = 2048, compute_r_precision: bool = False):
        self.tester = tester
        self.writer = writer
        self.eval_nums = eval_nums
        self.compute_r_precision = compute_r_precision
        self.results: Dict[int, Dict[str, float]] = {}

        self._extractor = None
        self._real = None
        if real_stats is not None:
            from eegan_tpu_torch.evaluation.fid import FIDExtractor, MeasureFID

            self._extractor = FIDExtractor(device=tester.device)
            self._real = MeasureFID(self._extractor).stats_for(real_stats)

        self._stream = (torch.cuda.Stream(tester.device)
                        if tester.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, epoch: int, g_params: Tensors, attr_params: Tensors,
               g_stats: Tensors) -> bool:
        """Queue a snapshot for evaluation: the generator's parameters and
        batch-norm buffers and AttrEnhance's parameters, by state-dict
        name. Returns False, dropping it, while the evaluator is busy, so
        training never blocks."""
        if self._q.full():
            return False
        snap = tuple({k: v.detach().clone() for k, v in d.items()}
                     for d in (g_params, attr_params, g_stats))
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record()  # on the caller's stream, after the clones
        try:
            self._q.put_nowait((epoch, snap, event))
            return True
        except queue.Full:
            return False

    def close(self, wait: bool = True):
        self._q.put(None)
        if wait:
            self._thread.join()

    # ------------------------------------------------------------------
    def _worker(self):
        stream = (contextlib.nullcontext() if self._stream is None
                  else torch.cuda.stream(self._stream))
        with stream:
            while True:
                item = self._q.get()
                if item is None:
                    return
                epoch, snap, event = item
                try:
                    if event is not None:
                        self._stream.wait_event(event)
                        for tensors in snap:
                            for t in tensors.values():
                                t.record_stream(self._stream)
                    self._evaluate(epoch, *snap)
                except Exception:
                    traceback.print_exc()
                    # Recorded, so that whoever waits on this epoch's
                    # result sees the failure and never hangs.
                    self.results[epoch] = {"eval/error": 1.0}

    def _evaluate(self, epoch: int, g_params: Tensors, attr_params: Tensors,
                  g_stats: Tensors) -> None:
        from eegan_tpu_torch.evaluation.fid import (
            activation_statistics,
            frechet_distance,
        )

        tester = self.tester
        tester.models.generator.load_state_dict({**g_params, **g_stats})
        tester.models.attr_enhance.load_state_dict(attr_params)
        rng = np.random.default_rng([epoch])
        noise_fn = tester.noise_fn(epoch * 99991)
        feats, hits = [], []
        for batch_idx, batch in enumerate(tester._batches(self.eval_nums,
                                                          rng)):
            imgs = tester.sample_step(
                batch["caps"], batch["cap_lens"], batch["attrs"],
                batch["attr_lens"], noise_fn(batch_idx, len(batch["caps"])))
            img256 = imgs[-1]  # stays on the device
            if self._extractor is not None:
                feats.append(self._extractor.features_device(img256)
                             .cpu().numpy())
            if self.compute_r_precision:
                hits.append(tester._r_precision_batch(batch, img256, 100,
                                                      rng))

        scalars: Dict[str, float] = {}
        if feats:
            mu, sigma = activation_statistics(np.concatenate(feats))
            scalars["eval/fid"] = frechet_distance(*self._real, mu, sigma)
        if hits:
            scalars["eval/r_precision"] = float(np.mean(np.concatenate(hits)))
        self.results[epoch] = scalars
        if self.writer is not None and scalars:
            self.writer.write_scalars(epoch, scalars)
        print(f"[async-eval] epoch {epoch}: {scalars}")
