"""Bucketed, resumable batch sampling (the port's own copy of the JAX package's
datasets/sampler.py).

The reference's NuScenesVariableBatchSampler (reference
magicdrivedit/datasets/nuscenes_variable.py:248-441) and StatefulDistributedSampler
(sampler.py:25-54). Buckets are keyed "H-W-fps-T"; every batch a sampler yields comes
from one bucket, so every batch has one shape.

All ranks construct identical access orders from (seed, epoch); each dp rank indexes
its slice, so no communication is needed. ``state_dict(num_steps)`` takes the
batches consumed in the current epoch and records the epoch; ``load_state_dict``
restores both, so the next iteration starts at the next batch.
"""
from __future__ import annotations

import random as pyrandom
from collections import OrderedDict, defaultdict
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["BucketSampler", "StatefulSampler"]


class StatefulSampler:
    """Resumable shuffling index sampler over one dataset (dp-sharded)."""

    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 batch_size: int = 1):
        self.num_samples = num_samples
        self.batch_size = batch_size  # indices a consumed batch takes
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_index = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.num_replicas
        return (self.num_samples + self.num_replicas - 1) // self.num_replicas

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.num_samples)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(order)
        if not self.drop_last:
            pad = (-len(order)) % self.num_replicas
            order = np.concatenate([order, order[:pad]])
        else:
            order = order[:len(order) - len(order) % self.num_replicas]
        local = order[self.rank::self.num_replicas]
        yield from local[self.start_index:].tolist()
        self.start_index = 0

    def state_dict(self, num_steps: int) -> dict:
        return {"epoch": self.epoch, "start_index": num_steps * self.batch_size}

    def load_state_dict(self, state: dict):
        self.epoch = state.get("epoch", self.epoch)
        self.start_index = state["start_index"]


class BucketSampler:
    """Yields per-rank micro-batches of string indices "idx-H-W-fps-T".

    buckets: {bucket_id: list of in-bucket sample indices} (see
    NuScenesMultiResDataset.as_buckets); bucket_config: {bucket_id: per-device batch
    size, -1 drops the bucket}. Matches the reference's access-order construction,
    divisibility padding, and `last_micro_batch_access_index` resume contract.
    """

    def __init__(self, buckets: "OrderedDict[str, List[int]]",
                 bucket_config: Dict[str, int], num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 verbose: bool = False):
        self.bs_config = dict(bucket_config)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.verbose = verbose
        self.epoch = 0
        self.last_micro_batch_access_index = 0

        self._bucket_sample_dict: "OrderedDict[str, List[int]]" = OrderedDict()
        self._bucket_micro_batch_count: "OrderedDict[str, int]" = OrderedDict()
        self.approximate_num_batch = 0
        for bucket_id, data_list in buckets.items():
            data_list = list(data_list)
            bs = self.bs_config.get(bucket_id, -1)
            if bs == -1:
                continue
            # Divisibility is at GLOBAL-batch granularity (bs * num_replicas):
            # every dp window draws all of its num_replicas micro-batches from
            # ONE bucket (see _access_order), so each global step has a single
            # shape. The reference pads only to bs and lets ranks diverge onto
            # different buckets (nuscenes_variable.py:248-441).
            group = bs * num_replicas
            remainder = len(data_list) % group
            if remainder > 0:
                if not drop_last:
                    pad = group - remainder
                    reps = -(-pad // max(1, len(data_list)))
                    data_list += (data_list * reps)[:pad]
                else:
                    data_list = data_list[:len(data_list) - remainder]
            if not data_list:
                continue
            self._bucket_sample_dict[bucket_id] = data_list
            n = len(data_list) // bs
            self._bucket_micro_batch_count[bucket_id] = n
            self.approximate_num_batch += n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return self.approximate_num_batch // self.num_replicas

    def reset(self):
        self.last_micro_batch_access_index = 0

    def _access_order(self, rng: pyrandom.Random) -> List[str]:
        """Micro-batch access order, grouped so each consecutive window of
        num_replicas entries is ONE bucket: all dp ranks of a step share the
        bucket key, keeping the assembled global batch single-shape. Shuffling
        happens at window granularity."""
        windows: List[str] = []
        for bucket_id, n in self._bucket_micro_batch_count.items():
            windows.extend([bucket_id] * (n // self.num_replicas))
        if self.shuffle:
            perm = list(range(len(windows)))
            rng.shuffle(perm)
            windows = [windows[i] for i in perm]
        order: List[str] = []
        for bucket_id in windows:
            order.extend([bucket_id] * self.num_replicas)
        return order

    def __iter__(self) -> Iterator[List[str]]:
        rng = pyrandom.Random(self.seed + self.epoch)
        samples = {}
        for bucket_id, data_list in self._bucket_sample_dict.items():
            if self.shuffle:
                perm = list(range(len(data_list)))
                rng.shuffle(perm)
                data_list = [data_list[i] for i in perm]
            samples[bucket_id] = data_list

        order = self._access_order(rng)
        num_iters = len(order) // self.num_replicas
        start_iter_idx = self.last_micro_batch_access_index // self.num_replicas
        self.last_micro_batch_access_index = start_iter_idx * self.num_replicas

        consumed: Dict[str, int] = defaultdict(int)
        for i in range(self.last_micro_batch_access_index):
            consumed[order[i]] += self.bs_config[order[i]]

        for i in range(start_iter_idx, num_iters):
            access = order[i * self.num_replicas: (i + 1) * self.num_replicas]
            self.last_micro_batch_access_index += self.num_replicas
            boundaries = []
            for bucket_id in access:
                bs = self.bs_config[bucket_id]
                start = consumed[bucket_id]
                boundaries.append((start, start + bs))
                consumed[bucket_id] += bs
            bucket_id = access[self.rank]
            lo, hi = boundaries[self.rank]
            yield [f"{idx}-{bucket_id}" for idx in samples[bucket_id][lo:hi]]
        self.reset()

    def bucket_stats(self) -> Dict[str, List[int]]:
        return {k: [len(v), self._bucket_micro_batch_count[k]]
                for k, v in self._bucket_sample_dict.items()}

    def state_dict(self, num_steps: int) -> dict:
        return {"seed": self.seed, "epoch": self.epoch,
                "last_micro_batch_access_index": num_steps * self.num_replicas}

    def load_state_dict(self, state: dict):
        self.__dict__.update(state)
