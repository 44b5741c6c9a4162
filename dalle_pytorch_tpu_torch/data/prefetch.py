"""Host-side input/compute overlap.

Counterpart of the JAX package's `data/prefetch.py`: `Prefetcher` runs a
batch iterator and a `transform` in one background thread with a bounded
queue, so that batch i+1 is decoded, tokenized and laid out while step i
runs; `wait_fraction` is the share of the consumer's wall time spent
blocked on the queue (~0: the input is hidden; ~1: it is the bottleneck).

On the card the thread stops at host memory: `host_tensors` turns a
batch's arrays into tensors, pinned when they are bound for a CUDA
device, and the consumer issues the copy itself with `to_device`
(non-blocking from pinned memory), so no thread but the main one touches
the compute stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


class _Sentinel:
    pass


_DONE = _Sentinel()


class Prefetcher:
    """Wrap a batch iterator; assemble + transform batches ahead of use.

    transform: host-side assembly (tokenizing, stacking, `host_tensors`)
    run in the background thread. depth bounds host memory: at most
    `depth` assembled batches exist beyond the one in use.
    """

    def __init__(
        self,
        batches: Iterable[Any],
        transform: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
    ):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._wait_s = 0.0
        self._t_start = time.perf_counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(batches),), daemon=True
        )
        self._thread.start()

    def _produce(self, it: Iterator[Any]) -> None:
        try:
            for raw in it:
                batch = self._transform(raw) if self._transform else raw
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate into the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self._wait_s += time.perf_counter() - t0
        if isinstance(item, _Sentinel):
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer early (break out of a partial epoch)."""
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # last-resort cleanup if the consumer abandoned iteration (e.g. the
        # train step raised): unblock the producer so it stops holding
        # assembled batches
        try:
            self._stop.set()
        except AttributeError:  # partially-constructed instance
            pass

    @property
    def wait_fraction(self) -> float:
        """Fraction of consumer wall time spent waiting on input."""
        total = time.perf_counter() - self._t_start
        return self._wait_s / total if total > 0 else 0.0


def host_tensors(arrays: Dict[str, np.ndarray], pin: bool) -> Dict[str, torch.Tensor]:
    """numpy arrays -> CPU tensors, in page-locked memory when `pin`."""
    out = {}
    for key, arr in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[key] = t.pin_memory() if pin else t
    return out


def to_device(tensors: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """The copies of `host_tensors`' output to `device`, issued on the
    current stream (non-blocking from pinned memory)."""
    return {k: t.to(device, non_blocking=t.is_pinned()) for k, t in tensors.items()}
