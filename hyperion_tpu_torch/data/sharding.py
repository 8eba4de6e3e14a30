"""One-device batching — `ShardedBatches` of
`hyperion_tpu/data/sharding.py:26-120` with one device in place of the
mesh.

The epoch order is the reference's: a permutation of the rows seeded by
`(seed, epoch)` (`np.random.default_rng((seed, epoch)).shuffle`, the
sampler's `set_epoch`), cut into global batches with the tail that
does not fill one dropped, and `start_step` skipping an already-trained
prefix. Each batch is gathered on the host (`host_epoch`, pinned on a
card, the `data_iter` chaos seam before each) and copied to the device
(`to_device`): from pinned memory the copy is queued on the current
stream and does not wait for the device. `epoch` chains the two; the
trainers run `host_epoch` on the prefetcher's thread and `to_device`
on their own. Meshes and sequence sharding wait for the distributed
runtime (ROADMAP A8).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from hyperion_tpu_torch.utils.retry import fault_point


class ShardedBatches:
    """Iterate dict-of-arrays data as device batches of `global_batch`
    rows (drop-last)."""

    def __init__(self, arrays: dict[str, np.ndarray], global_batch: int,
                 device, shuffle: bool = True, seed: int = 0):
        lens = {k: v.shape[0] for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged arrays: {lens}")
        self.arrays = arrays
        self.n = next(iter(lens.values()))
        if global_batch > self.n:
            raise ValueError(f"global_batch {global_batch} > dataset size "
                             f"{self.n}")
        self.global_batch = global_batch
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.steps_per_epoch = self.n // global_batch

    def host_epoch(self, epoch: int,
                   start_step: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        """One pass over the data from batch `start_step` on, as host
        tensors (pinned when the device is a card); `epoch` seeds the
        row order."""
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        pin = self.device.type == "cuda"
        for s in range(start_step, self.steps_per_epoch):
            fault_point("data_iter")
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            rows = {k: torch.from_numpy(v[idx]) for k, v in self.arrays.items()}
            yield {k: t.pin_memory() if pin else t for k, t in rows.items()}

    def to_device(self, batch: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """A `host_epoch` batch on the device. From pinned memory the
        copy is queued on the stream; from pageable memory torch waits
        for the stream to drain first."""
        pin = self.device.type == "cuda"
        return {k: t.to(self.device, non_blocking=pin)
                for k, t in batch.items()}

    def epoch(self, epoch: int,
              start_step: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        """`host_epoch`'s batches on the device."""
        for batch in self.host_epoch(epoch, start_step):
            yield self.to_device(batch)

    def __len__(self) -> int:
        return self.steps_per_epoch
