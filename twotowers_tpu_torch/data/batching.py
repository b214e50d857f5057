"""Static-shape batching: fixed (B, L) batches with pad weights.

The counterpart of ``twotowers_tpu/data/batching.py``. Every batch has the
same shape: the final short batch is zero-padded (token id 0 == PAD) up to
``batch_size`` and carries a float weight vector (1 real / 0 pad) that the
loss and metric code use to mask padding, so epoch means are means over the
real samples. ``iterate_batches`` is a copy (numpy); the device transfer is
a pinned-memory ``.to(device, non_blocking=True)``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Batch:
    """One statically shaped training batch (numpy on the host, tensors
    after ``place_on_device``).

    ``negatives`` is ``None`` for pair-arity losses, ``(B, L)`` for one
    negative per row, or ``(B, N, L)`` for multi-negative groups.
    """

    queries: Any
    positives: Any
    negatives: Optional[Any]
    weights: Any
    num_real_hint: Optional[int] = None

    @property
    def num_real(self) -> int:
        if self.num_real_hint is not None:
            return int(self.num_real_hint)
        return int(round(float(np.asarray(self.weights).sum())))


def num_batches(num_samples: int, batch_size: int, *,
                drop_remainder: bool = False) -> int:
    if drop_remainder:
        return num_samples // batch_size
    return -(-num_samples // batch_size)


def _pad_to(array: np.ndarray, batch_size: int) -> np.ndarray:
    short = batch_size - array.shape[0]
    if short <= 0:
        return array
    pad_width = [(0, short)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width)  # zero rows == all-PAD sequences


def iterate_batches(
    arrays: Sequence[Optional[np.ndarray]],
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Batch]:
    """Yield fixed-shape :class:`Batch` objects over ``(q, p, n)`` arrays.

    ``n`` may be ``None``. Shuffling is a seeded full permutation so every
    real sample appears exactly once per epoch and order is reproducible.
    """
    queries, positives, negatives = arrays
    n_samples = queries.shape[0]
    order = np.arange(n_samples)
    if shuffle:
        order = np.random.default_rng(seed).permutation(n_samples)

    for start in range(0, n_samples, batch_size):
        idx = order[start:start + batch_size]
        real = idx.shape[0]
        if real < batch_size and drop_remainder:
            return
        weights = np.zeros(batch_size, np.float32)
        weights[:real] = 1.0
        yield Batch(
            queries=_pad_to(queries[idx], batch_size),
            positives=_pad_to(positives[idx], batch_size),
            negatives=None if negatives is None else _pad_to(negatives[idx], batch_size),
            weights=weights,
            num_real_hint=real,
        )


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        # a pinned source lets the copy run asynchronously to the host
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def place_on_device(batch: Batch, device: Union[str, torch.device] = "cuda") -> Batch:
    """Copy one batch's arrays host -> device (the only H2D boundary)."""
    device = torch.device(device)
    return Batch(
        queries=_to_device(batch.queries, device),
        positives=_to_device(batch.positives, device),
        negatives=None if batch.negatives is None else _to_device(batch.negatives, device),
        weights=_to_device(batch.weights, device),
        num_real_hint=batch.num_real,
    )


def prefetch_to_device(batches: Iterable[Batch], *, depth: int = 2,
                       device: Union[str, torch.device] = "cuda") -> Iterator[Batch]:
    """Keep ``depth`` batches in flight so H2D copies overlap the step.

    CUDA copies from pinned memory are asynchronous, so issuing them for
    upcoming batches before the current step's results are read hides the
    transfer behind compute.
    """
    queue: collections.deque = collections.deque()
    for batch in batches:
        queue.append(place_on_device(batch, device))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
