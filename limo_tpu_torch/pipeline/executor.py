"""Pipelined host executor — the reference gets pipeline parallelism from
ROS nodelets chained by topics (``launch/kitti_standalone.launch:10-57``:
preproc → tracker → depth → labels → BA each in its own thread with message
queues). Without ROS, the same overlap comes from a bounded prefetch
executor: frame *loading/decoding* (disk IO, velodyne parsing — the stages
with no device dependency) runs in a thread pool a few frames ahead of the
compute stage that consumes them.

IO threads release the GIL (file reads, numpy decode, the native velodyne
loader), so a 2-worker pool genuinely overlaps with the host-side tracker
and the device solve.

A copy of the reference package's ``limo_tpu/pipeline/executor.py``. The
loader threads do numpy and file work only: every CUDA call of a frame is
issued from the consuming thread, in ``pipe.process``.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


class PrefetchExecutor:
    """Iterate ``load(item)`` over ``items`` with up to ``prefetch`` loads
    in flight, yielding results strictly in order (the topic-queue
    semantics of the reference's nodelet chain)."""

    def __init__(self, load: Callable[..., T], items: Iterable,
                 prefetch: int = 3, workers: int = 2):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self._load = load
        self._items = list(items)
        self._prefetch = prefetch
        self._workers = workers

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[T]:
        if not self._items:
            return
        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            pending = collections.deque()
            it = iter(self._items)
            try:
                for _ in range(self._prefetch):
                    pending.append(pool.submit(self._load, next(it)))
            except StopIteration:
                it = iter(())
            while pending:
                out = pending.popleft().result()
                try:
                    pending.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    pass
                yield out


def run_pipelined(pipe, frames: Iterable, load: Callable,
                  prefetch: int = 3, workers: int = 2) -> list:
    """Drive a :class:`~limo_tpu_torch.pipeline.full.LimoPipeline` with loading
    overlapped against compute. ``load(frame) -> (stamp, image, cloud)`` or
    ``(stamp, image, cloud, label_image)`` (cloud/label may be None);
    returns the per-frame results."""
    results = []
    for item in PrefetchExecutor(load, frames, prefetch, workers):
        stamp, image, cloud = item[:3]
        if len(item) > 3:
            results.append(pipe.process(stamp, image, cloud,
                                        label_image=item[3]))
        else:  # 3-tuple loaders work with any pipe-like object
            results.append(pipe.process(stamp, image, cloud))
    return results
