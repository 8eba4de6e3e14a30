"""Batching over the mesh — `ShardedBatches` of
`hyperion_tpu/data/sharding.py:26-120`.

The epoch order is the reference's: a permutation of the rows seeded by
`(seed, epoch)` (`np.random.default_rng((seed, epoch)).shuffle`, the
sampler's `set_epoch`), cut into global batches with the tail that
does not fill one dropped, and `start_step` skipping an already-trained
prefix. Each batch is gathered on the host (`host_epoch`, pinned on a
card, the `data_iter` chaos seam before each) and copied to the device
(`to_device`): from pinned memory the copy is queued on the current
stream and does not wait for the device. `epoch` chains the two; the
trainers run `host_epoch` on the prefetcher's thread and `to_device`
on their own.

With a mesh (`mesh=`), every rank draws the same global permutation from
the seed and keeps the rows of each global batch that its (data, fsdp)
coordinate owns (`runtime/mesh.py` `batch_rows`; `rows` names the axes
the rows split over, (data, fsdp) by default and (data, fsdp, expert)
for the language jobs), the rows `make_array_from_callback` hands that
shard in the JAX package; ranks that differ only on another axis get
the same rows. With `seq_shard` (a seq axis > 1, `seq_shard` of the
reference's `ShardedBatches`) each rank keeps its slice of every row's
positions (`seq_cols`), and adds the next-token targets of that slice,
`target_ids` and `target_mask`: the ids and mask one position on, the
last global position masked, since the target of a slice's last
position lies on the next rank (`train/losses.py`).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from hyperion_tpu_torch.runtime.mesh import AxisName, batch_rows, seq_cols
from hyperion_tpu_torch.utils.retry import fault_point


class ShardedBatches:
    """Iterate dict-of-arrays data as device batches of `global_batch`
    rows (drop-last); with a mesh, this rank's rows of each."""

    def __init__(self, arrays: dict[str, np.ndarray], global_batch: int,
                 device, shuffle: bool = True, seed: int = 0, mesh=None,
                 rows: tuple = AxisName.BATCH, seq_shard: bool = False):
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
        # this rank's rows of a global batch (all of them without a mesh)
        self.rows = (slice(0, global_batch) if mesh is None
                     else batch_rows(mesh, global_batch, rows))
        self.cols = None
        if seq_shard:
            T = arrays["input_ids"].shape[1]
            self.cols = seq_cols(mesh, T)
            self.arrays = dict(arrays, **next_tokens(arrays))

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
            idx = order[s * self.global_batch:
                        (s + 1) * self.global_batch][self.rows]
            rows = {k: torch.from_numpy(v[idx] if self.cols is None
                                        else v[idx, self.cols])
                    for k, v in self.arrays.items()}
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


def next_tokens(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Every position's next token and whether it is scored: the ids and
    mask shifted one position left, the last position masked."""
    ids, mask = arrays["input_ids"], arrays["attention_mask"]
    tgt = np.zeros_like(ids)
    tgt[:, :-1] = ids[:, 1:]
    tmask = np.zeros_like(mask)
    tmask[:, :-1] = mask[:, 1:]
    return {"target_ids": tgt, "target_mask": tmask}
