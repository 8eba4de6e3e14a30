"""One-device batching — `ShardedBatches` of
`hyperion_tpu/data/sharding.py:26-120` with one device in place of the
mesh.

The epoch order is the reference's: a permutation of the rows seeded by
`(seed, epoch)` (`np.random.default_rng((seed, epoch)).shuffle`, the
sampler's `set_epoch`), cut into global batches with the tail that
does not fill one dropped, and `start_step` skipping an already-trained
prefix. Each batch is gathered on the host and copied to the device as
tensors, through pinned memory on a card so the copy does not wait for
the device. Meshes and sequence sharding wait for the distributed
runtime (ROADMAP A8).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


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

    def epoch(self, epoch: int,
              start_step: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        """One pass over the data from batch `start_step` on; `epoch`
        seeds the row order."""
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        pin = self.device.type == "cuda"
        for s in range(start_step, self.steps_per_epoch):
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            rows = {k: torch.from_numpy(v[idx]) for k, v in self.arrays.items()}
            # from pinned memory the copy is queued on the stream; from
            # pageable memory torch waits for the stream to drain first
            yield {k: (t.pin_memory() if pin else t).to(self.device,
                                                        non_blocking=pin)
                   for k, t in rows.items()}

    def __len__(self) -> int:
        return self.steps_per_epoch
