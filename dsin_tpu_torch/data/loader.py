"""Host-side data pipeline: paired stereo images -> batches (a copy of the
JAX package's `data/loader.py`, its PNGs decoded by `data/png.py` instead of
PIL, so it reads PNG files only).

Batches of (x, y) float32 NHWC, x the image to compress and y the
side-information image, shardable across hosts.

Pipeline (training; reference DataProvider.py:102-140 semantics):
  shuffle pair list -> decode both PNGs -> `num_crops_per_img` random
  (crop_h, crop_w) crops of the stacked 6-channel pair (+ optional LR flip)
  -> the x side is *re-cropped* to the model crop within the y crop
  (reference keeps y at full crop so the search has context; with equal
  sizes this is an identity re-crop) -> crop-level shuffle buffer -> batches
  (drop_remainder) -> prefetch thread.

Validation/test: deterministic center crops, no flip, in manifest order
(reference DataProvider.py:62-94,151-184).
"""

from __future__ import annotations

import collections
import os
import concurrent.futures
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dsin_tpu_torch.data.png import read_png


def decode_image(path: str) -> np.ndarray:
    """PNG -> (H, W, 3) uint8 RGB (`data/png.py`)."""
    return read_png(path)


def random_pair_crops(pair_6ch: np.ndarray, crop_h: int, crop_w: int,
                      num_crops: int, do_flip: bool,
                      rng: np.random.Generator) -> List[np.ndarray]:
    """`num_crops` random crops of the stacked (H, W, 6) pair."""
    h, w, _ = pair_6ch.shape
    assert h >= crop_h and w >= crop_w, (pair_6ch.shape, crop_h, crop_w)
    out = []
    for _ in range(num_crops):
        top = int(rng.integers(0, h - crop_h + 1))
        left = int(rng.integers(0, w - crop_w + 1))
        crop = pair_6ch[top:top + crop_h, left:left + crop_w, :]
        if do_flip and rng.random() < 0.5:
            crop = crop[:, ::-1, :]
        out.append(np.ascontiguousarray(crop))
    return out


def center_pair_crop(pair_6ch: np.ndarray, crop_h: int,
                     crop_w: int) -> np.ndarray:
    h, w, _ = pair_6ch.shape
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    return np.ascontiguousarray(pair_6ch[top:top + crop_h,
                                         left:left + crop_w, :])


def _split_xy(crop_6ch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (crop_6ch[..., :3].astype(np.float32),
            crop_6ch[..., 3:].astype(np.float32))


class PairDataset:
    """Iterable dataset over correlated image pairs.

    Args:
      pairs: list of (x_path, y_path); usually from `read_pair_manifest`.
      crop_size: (H, W) output crop.
      batch_size: per-host batch size.
      train: random crops + shuffle (+ flips) vs deterministic center crops.
      num_crops_per_img, do_flips, shuffle_buffer: training-pipeline knobs.
      host_id/num_hosts: shard the pair list across hosts (multi-host data
        parallelism; each host sees pairs[host_id::num_hosts]).
      seed: RNG seed for shuffling/cropping.
      decode_workers: PNG-decode thread-pool size (the analog of the
        reference's `num_parallel_calls=6` tf.data maps,
        DataProvider.py:6,131-132). zlib's inflate and numpy release the
        GIL, so decodes overlap on multi-core hosts. 0/1 = inline
        decoding. Default None = min(6, cpu_count).
    """

    def __init__(self, pairs: Sequence[Tuple[str, str]],
                 crop_size: Tuple[int, int], batch_size: int,
                 train: bool, num_crops_per_img: int = 1,
                 do_flips: bool = True, shuffle_buffer: int = 50,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0,
                 decode_fn=decode_image,
                 decode_workers: Optional[int] = None):
        self.pairs = list(pairs)[host_id::num_hosts]
        if not self.pairs:
            raise ValueError("no pairs for this host shard")
        self.crop_h, self.crop_w = crop_size
        self.batch_size = batch_size
        self.train = train
        self.num_crops = num_crops_per_img if train else 1
        self.do_flips = do_flips and train
        self.shuffle_buffer = max(shuffle_buffer * self.num_crops, 1)
        self.rng = np.random.default_rng(seed + host_id)
        self.decode_fn = decode_fn
        if decode_workers is None:
            decode_workers = min(6, os.cpu_count() or 1)
        self.decode_workers = decode_workers
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def __len__(self) -> int:
        return len(self.pairs)

    def close(self) -> None:
        """Shut down the decode pool. Idempotent; the dataset remains
        usable afterwards (a fresh pool is created on demand). Call this
        on short-lived datasets (per-validation/test passes) so idle
        decode threads never outlive their pass."""
        pool = getattr(self, "_pool", None)   # absent if __init__ raised
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def num_batches_per_epoch(self) -> int:
        return (len(self.pairs) * self.num_crops) // self.batch_size

    def _decode_pair(self, idx: int) -> np.ndarray:
        x_path, y_path = self.pairs[idx]
        return np.concatenate(
            [self.decode_fn(x_path), self.decode_fn(y_path)], axis=-1)

    def _decoded_stream(self, order) -> Iterator[np.ndarray]:
        """Decoded (H, W, 6) pairs in `order`'s order.

        Decodes run on a shared thread pool with a bounded in-flight
        window (2x workers) — epoch order and every RNG draw happen on
        the consumer side, so the stream is bit-identical to inline
        decoding, just overlapped."""
        if self.decode_workers <= 1:
            for idx in order:
                yield self._decode_pair(idx)
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="pair-decode")
        inflight: "collections.deque" = collections.deque()
        it = iter(order)
        try:
            for idx in it:
                inflight.append(self._pool.submit(self._decode_pair, idx))
                if len(inflight) >= 2 * self.decode_workers:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            while inflight:
                inflight.popleft().cancel()

    def _crop_stream(self, loop: bool) -> Iterator[np.ndarray]:
        while True:
            order = (self.rng.permutation(len(self.pairs)) if self.train
                     else np.arange(len(self.pairs)))
            for pair in self._decoded_stream(order):
                if self.train:
                    yield from random_pair_crops(
                        pair, self.crop_h, self.crop_w, self.num_crops,
                        self.do_flips, self.rng)
                else:
                    yield center_pair_crop(pair, self.crop_h, self.crop_w)
            if not loop:
                return

    def _shuffled_stream(self, loop: bool) -> Iterator[np.ndarray]:
        if not self.train:
            yield from self._crop_stream(loop)
            return
        buf: List[np.ndarray] = []
        for crop in self._crop_stream(loop):
            buf.append(crop)
            if len(buf) >= self.shuffle_buffer:
                j = int(self.rng.integers(0, len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        self.rng.shuffle(buf)
        yield from buf

    def batches(self, loop: Optional[bool] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) float32 NHWC batches. Training loops forever by
        default; eval runs one epoch (drop_remainder)."""
        loop = self.train if loop is None else loop
        batch: List[np.ndarray] = []
        for crop in self._shuffled_stream(loop):
            batch.append(crop)
            if len(batch) == self.batch_size:
                stacked = np.stack(batch)
                batch = []
                yield _split_xy(stacked)


class Prefetcher:
    """Background-thread prefetch of an iterator (the tf.data `prefetch(1)`
    analog; decode/crop overlaps with device compute)."""

    _DONE = object()

    def __init__(self, iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(
            target=self._fill, args=(iterator,), daemon=True)
        self._err: Optional[BaseException] = None
        self._thread.start()

    def _fill(self, iterator):
        try:
            for item in iterator:
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
