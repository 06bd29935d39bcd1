"""Host input pipeline: threaded batch assembly + device prefetch (port of
chap_tpu/data/pipeline.py), the ``data.device_input=false`` path.

A thread pool assembles numpy batches ahead of the train loop (the
reference's DataLoader(num_workers=4, pin_memory=True),
train_ours_2D.py:274); ``prefetch_to_device`` copies them from pinned host
memory with ``non_blocking=True`` and keeps ``size`` batches in flight, so
the copy of the next batch overlaps the current step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch


class BatchLoader:
    """Iterate a dataset with a batch sampler on background threads.

    Yields dicts of stacked numpy arrays: image [B,1,H,W] (NCHW), label
    [B,H,W] int32, in the sampler's order. A worker that raises fails the
    consumer with a RuntimeError chained to the cause.
    """

    def __init__(self, dataset, batch_sampler: Iterable, num_workers: int = 4,
                 queue_depth: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.queue_depth = queue_depth

    @staticmethod
    def _collate(samples) -> Dict[str, np.ndarray]:
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        if images.ndim == 3:  # [B,H,W] -> NCHW
            images = images[:, None]
        labels = np.stack([s["label"] for s in samples]).astype(np.int32)
        return {"image": images, "label": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.batch_sampler)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()

        def put(slot_q, item) -> bool:
            # a consumer that stops early (the trainer at its last step) sets
            # ``stop``; a worker blocked on a full queue then exits
            while not stop.is_set():
                try:
                    slot_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker(batch_indices_list, slot_q):
            # a raising dataset must surface in the consumer, not kill the
            # daemon thread and deadlock the ordered-emit loop below
            for bi, indices in batch_indices_list:
                try:
                    samples = [self.dataset[i] for i in indices]
                    item = (bi, self._collate(samples))
                except BaseException as exc:  # noqa: BLE001 -- re-raised below
                    put(slot_q, (bi, exc))
                    return
                if not put(slot_q, item):
                    return

        # shard batches round-robin over workers but emit in order
        assignments = [[] for _ in range(self.num_workers)]
        for bi, idxs in enumerate(batches):
            assignments[bi % self.num_workers].append((bi, idxs))
        threads = [threading.Thread(target=worker, args=(a, out_q), daemon=True)
                   for a in assignments if a]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Dict[str, np.ndarray]] = {}
            next_bi = 0
            for _ in range(len(batches)):
                bi, batch = out_q.get()
                if isinstance(batch, BaseException):
                    raise RuntimeError(
                        f"BatchLoader worker failed on batch {bi}") from batch
                pending[bi] = batch
                while next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
        finally:
            stop.set()


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy (or host tensor) batch -> tensors on ``device``: through pinned
    host memory with a non-blocking copy for a CUDA device (PyTorch's pinned
    allocator keeps the host buffer alive until the copy is done)."""
    out = {}
    for key, value in batch.items():
        t = (value.contiguous() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(value)))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def prefetch_to_device(iterator: Iterable, device: Union[str, torch.device],
                       size: int = 2,
                       transform: Optional[Callable] = None) -> Iterator:
    """Keep ``size`` batches already copied (or in flight) to ``device`` while
    the step runs; ``transform`` is applied to each numpy batch first."""
    device = torch.device(device)
    buf = []
    for batch in iterator:
        if transform is not None:
            batch = transform(batch)
        buf.append(to_device(batch, device))
        if len(buf) >= size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)


def compact_batch(batch: dict, compute_dtype: torch.dtype = torch.float32
                  ) -> dict:
    """Shrink the host->device payload: images in the model's compute dtype
    (float32 as numpy; bf16, which numpy lacks, as a host tensor rounded to
    nearest, as chap_tpu's ml_dtypes cast), integer labels as uint8 (exact;
    num_classes < 256). The train steps widen the labels on the device."""
    out = dict(batch)
    image = np.asarray(batch["image"]).astype(np.float32)
    out["image"] = (image if compute_dtype == torch.float32 else
                    torch.from_numpy(np.ascontiguousarray(image)).to(compute_dtype))
    label = np.asarray(batch["label"])
    if np.issubdtype(label.dtype, np.integer):
        out["label"] = label.astype(np.uint8)
    return out
