"""Async host-IO stream: trajectory frames and checkpoints off the hot loop.

SURVEY §5/§7 design clause ("orbax-style async save off the device;
async trajectory stream on a side thread") — the reference writes its
``position_buffer.txt`` frames synchronously on the render thread
(the reference's `src/owHelper.cpp:1640-1672`); at fast-engine speed a
synchronous ~130k-row text append is a per-dump stall of many steps.

Design: ONE daemon worker thread and a bounded queue. ``submit`` hands
the writer callable plus its arguments *without* materializing device
arrays — the worker calls ``np.asarray`` itself, so the device->host
transfer AND the host-side formatting/compression both overlap the main
thread's next dispatch (jax arrays are safe to read from another
thread). The bounded queue applies backpressure (at most ``maxsize``
frames of host memory in flight); ``flush()`` drains; a worker exception
is captured and re-raised on the next ``submit``/``flush`` so IO errors
cannot pass silently.
"""
from __future__ import annotations

import logging
import os
import queue
import threading

import numpy as np

logger = logging.getLogger("sph_jax")

_SENTINEL = object()


def _materialize(x):
    return np.asarray(x) if hasattr(x, "shape") else x


class AsyncWriter:
    """Single-worker ordered async executor for host IO."""

    def __init__(self, maxsize: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="sph-async-io", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                fn, args, kw = item
                fn(*[_materialize(a) for a in args], **kw)
            except BaseException as e:  # surfaced on next submit/flush
                if self._err is None:
                    self._err = e
                logger.error("async IO failed: %r", e)
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async IO write failed") from err

    def submit(self, fn, *args, **kw) -> None:
        """Enqueue ``fn(*np.asarray(args), **kw)``; blocks only when
        ``maxsize`` writes are already in flight (backpressure)."""
        self._raise_pending()
        if self._done.is_set():
            raise RuntimeError("AsyncWriter is closed")
        self._q.put((fn, args, kw))

    def flush(self) -> None:
        """Wait until every submitted write has completed."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        self._q.put(_SENTINEL)
        self._thread.join()
        self._raise_pending()


def save_npz_atomic(path: str, **arrays) -> None:
    """np.savez_compressed via a temp file + os.replace: a crash mid-write
    can never leave a truncated archive at the target path."""
    tmp = path + ".tmp.npz"  # savez appends .npz to other suffixes
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
