"""Host-side prefetching dataloader (thread pool + bounded queue; the port's own
copy of the JAX package's datasets/dataloader.py).

In place of the reference's torch DataLoader + worker-process stack (reference
magicdrivedit/datasets/dataloader.py:27-136). The input pipeline is host work (JPEG
decode, homographies, rasterization) that overlaps the device's steps; threads, since
numpy and PIL release the GIL in the hot parts and no worker process has to pickle
large arrays.

`prepare_dataloader` mirrors the reference's sampler selection: BucketSampler for
multi-res datasets, StatefulSampler otherwise. Batches from the bucket sampler are
lists of "idx-H-W-fps-T" string indices; items are collated with `collate_clips`.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from .collate import collate_clips, pad_clip_to_t
from .sampler import BucketSampler, StatefulSampler

__all__ = ["DataLoader", "prepare_dataloader", "prepare_multirank_dataloader",
           "concat_batches"]

_STOP = object()


class DataLoader:
    """Batches of ``batch_sampler`` through ``collate_fn``, prepared ahead on a
    producer thread: every item of the next ``prefetch`` batches is loaded on its
    own task of a ``num_workers``-thread pool (so one batch takes about as long as
    its slowest item when there are enough workers), and at most ``prefetch``
    finished batches wait in the queue. Batches come in the sampler's order."""

    def __init__(self, dataset, batch_sampler, collate_fn: Callable = collate_clips,
                 num_workers: int = 2, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.batch_sampler)

    @staticmethod
    def _put(out_q: "queue.Queue", item, stop: threading.Event) -> bool:
        """Put unless the consumer has stopped; False once it has."""
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _produce(self, out_q: "queue.Queue", stop: threading.Event):
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending: "collections.deque" = collections.deque()

                def finish_oldest() -> bool:
                    items = [f.result() for f in pending.popleft()]
                    return self._put(out_q, self.collate_fn(items), stop)

                for batch_indices in self.batch_sampler:
                    if stop.is_set():
                        break
                    pending.append([pool.submit(self.dataset.__getitem__, i)
                                    for i in batch_indices])
                    if len(pending) >= self.prefetch and not finish_oldest():
                        break
                while pending and not stop.is_set():
                    if not finish_oldest():
                        break
                for futures in pending:  # left by a consumer that stopped
                    for f in futures:
                        f.cancel()
        except Exception as e:  # surface loader errors to the consumer
            self._put(out_q, e, stop)
        finally:
            self._put(out_q, _STOP, stop)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(target=self._produce, args=(out_q, stop),
                                    daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is _STOP:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()  # the producer ends within its put timeout
            producer.join()


def make_full_bucket_collate(full_bucket_t: int,
                             collate_fn: Callable = collate_clips) -> Callable:
    """Collate that pads ragged "full" scenes (dataset items flagged
    `is_full_clip`) to ONE bucket max-T before stacking, so the whole full
    bucket trains at one shape.
    Scenes whose fps-subsampled length is not 8n+1 are first trimmed down to
    8n+1 — the same micro-frame rule build_clips applies at the base rate."""
    def collate(items):
        out = []
        for it in items:
            if it.pop("is_full_clip", False):
                t = (it["pixel_values"].shape[0]
                     if it.get("pixel_values") is not None
                     else int(it["pixel_values_shape"][0]))  # drop_ori_imgs
                t8 = (t - 1) // 8 * 8 + 1
                if t8 != t:
                    it = {k: (v[:t8] if k in ("pixel_values", "bev_map_with_aux",
                                              "camera_param", "frame_emb",
                                              "human_imgs", "human_masks",
                                              "captions") and v is not None
                              else v) for k, v in it.items()}
                    if it.get("bboxes_3d_data") is not None:
                        it["bboxes_3d_data"] = {k: v[:t8] for k, v in
                                                it["bboxes_3d_data"].items()}
                    if it.get("pixel_values_shape") is not None:
                        shp = np.asarray(it["pixel_values_shape"]).copy()
                        shp[0] = t8
                        it["pixel_values_shape"] = shp
                it = pad_clip_to_t(it, full_bucket_t)
            out.append(it)
        return collate_fn(out)
    return collate


def prepare_dataloader(dataset, *, bucket_config: Optional[Dict[str, int]] = None,
                       batch_size: int = 1, num_replicas: int = 1, rank: int = 0,
                       shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                       num_workers: int = 2, prefetch: int = 2,
                       collate_fn: Callable = collate_clips,
                       full_bucket_t: Optional[int] = None):
    """Build (loader, sampler). Bucketed path when the dataset exposes
    `as_buckets()` (multi-res), plain stateful sampling otherwise.
    full_bucket_t: bucket max-T for ragged "full" scenes (see
    make_full_bucket_collate); derived via `max_full_clip_len` by callers."""
    if full_bucket_t is not None:
        collate_fn = make_full_bucket_collate(full_bucket_t, collate_fn)
    if hasattr(dataset, "as_buckets") and bucket_config is not None:
        sampler = BucketSampler(dataset.as_buckets(), bucket_config,
                                num_replicas=num_replicas, rank=rank,
                                shuffle=shuffle, seed=seed, drop_last=drop_last)
        loader = DataLoader(dataset, sampler, collate_fn=collate_fn,
                            num_workers=num_workers, prefetch=prefetch)
        return loader, sampler

    sampler = StatefulSampler(len(dataset), num_replicas=num_replicas, rank=rank,
                              shuffle=shuffle, seed=seed, drop_last=drop_last,
                              batch_size=batch_size)

    class _Batches:
        def __iter__(self_inner):
            batch = []
            for idx in sampler:
                batch.append(idx)
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch and not drop_last:
                yield batch

        def __len__(self_inner):
            n = len(sampler)
            return n // batch_size if drop_last else -(-n // batch_size)

    loader = DataLoader(dataset, _Batches(), collate_fn=collate_fn,
                        num_workers=num_workers, prefetch=prefetch)
    return loader, sampler


def _pad_boxes_to(d: Dict[str, Any], max_len: int) -> Dict[str, Any]:
    """Pad a collated bboxes_3d_data dict (L at axis 3) to a common max_len,
    with the same fill values collate_clips uses (classes -1, masks 0)."""
    import numpy as np

    cur = d["bboxes"].shape[3]
    if cur == max_len:
        return d

    def pad(a, fill):
        widths = [(0, 0)] * a.ndim
        widths[3] = (0, max_len - cur)
        return np.pad(a, widths, constant_values=fill)

    return {"bboxes": pad(d["bboxes"], 0), "classes": pad(d["classes"], -1),
            "masks": pad(d["masks"], 0)}


def concat_batches(batches) -> Dict[str, Any]:
    """Row-concat collate_clips outputs from the SAME bucket: arrays along axis
    0 (bbox dicts re-padded to a common box count first), caption lists
    appended, per-bucket scalars (height/width/num_frames) asserted equal."""
    import numpy as np

    if len(batches) == 1:
        return batches[0]
    out: Dict[str, Any] = {}
    for k, v in batches[0].items():
        if k in ("height", "width", "num_frames"):
            assert all(b[k] == v for b in batches[1:]), \
                f"rank batches diverged on bucket key {k}"
            out[k] = v
        elif v is None:
            out[k] = None
        elif isinstance(v, dict):
            max_len = max(b[k]["bboxes"].shape[3] for b in batches)
            padded = [_pad_boxes_to(b[k], max_len) for b in batches]
            out[k] = {kk: np.concatenate([p[kk] for p in padded])
                      for kk in padded[0]}
        elif isinstance(v, list):
            out[k] = [item for b in batches for item in b[k]]
        else:
            out[k] = np.concatenate([b[k] for b in batches])
    return out


class ConcatLoader:
    """Zip one loader per local dp rank and row-concat their batches: the
    global-batch assembly the reference gets from torchrun's per-rank processes
    (reference dataloader.py + NCCL dp group). One process: ranks 0..dp-1 give
    the whole global batch."""

    def __init__(self, loaders):
        self.loaders = list(loaders)

    def __len__(self):
        return min(len(ld) for ld in self.loaders)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batches in zip(*self.loaders):
            yield concat_batches(list(batches))


class MultiRankSampler:
    """Epoch/resume fan-out over the per-rank samplers backing a ConcatLoader
    (identical access orders by construction — state is rank-invariant)."""

    def __init__(self, samplers):
        self.samplers = list(samplers)

    def set_epoch(self, epoch: int):
        for s in self.samplers:
            s.set_epoch(epoch)

    def state_dict(self, num_steps: int) -> dict:
        return self.samplers[0].state_dict(num_steps)

    def load_state_dict(self, state: dict):
        for s in self.samplers:
            s.load_state_dict(state)


def prepare_multirank_dataloader(dataset, *, dp_total: int, dp_local: int,
                                 dp_offset: int = 0, **kw):
    """(loader, sampler) covering dp rows [dp_offset, dp_offset+dp_local) of a
    dp_total-way data split — one prepare_dataloader per row, concatenated.
    One process passes dp_local=dp_total, dp_offset=0 and gets the full global
    batch per step (batch_size rows per dp rank, reference semantics)."""
    pairs = [prepare_dataloader(dataset, num_replicas=dp_total, rank=r, **kw)
             for r in range(dp_offset, dp_offset + dp_local)]
    loaders = [p[0] for p in pairs]
    samplers = [p[1] for p in pairs]
    if len(loaders) == 1:
        return loaders[0], samplers[0]
    return ConcatLoader(loaders), MultiRankSampler(samplers)
