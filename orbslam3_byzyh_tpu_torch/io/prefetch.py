"""Ordered multithreaded image loader: the port's counterpart of the JAX
package's ``native/`` prefetcher (C++ on OpenCV's imgcodecs).

The contract is the JAX one (``native/__init__.py:63-123``): iterate to get
``(idx, image)`` in the order of ``paths``; at most ``capacity`` images are
decoded ahead of the consumer; ``close()`` stops the workers; a file that
cannot be read or decoded raises ``IOError`` naming it when its turn comes.

Worker threads read and inflate the files (``io.png.inflate``; zlib
releases the GIL) and, for the card, copy the filtered scanlines into
page-locked memory. The iterating thread queues their upload, which does
not wait, and launches P1 (``ops.cuda_png``) on the current stream, the
one the system then runs on:
the image arrives as a float32 tensor on the device and never returns to
the host. On the CPU the workers also run the plain unfilter and the
iterator yields numpy float32 images.

``modes``: per path (or one for all) ``"grey"`` (``cv2.IMREAD_GRAYSCALE``)
or ``"unchanged"`` (a grey file's stored value, 16-bit depth included, as
float32).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import device as device_mod
from ..ops import cuda_png
from . import png


class ImagePrefetcher:
    """Ordered multithreaded image loader. Iterate to get (idx, image)."""

    def __init__(self, paths, n_threads: int = 4, capacity: int = 8,
                 device=None, modes="grey"):
        self._paths = list(paths)
        self._modes = ([modes] * len(self._paths) if isinstance(modes, str)
                       else list(modes))
        if len(self._modes) != len(self._paths):
            raise ValueError("one mode per path")
        self.device = device_mod.resolve(device)
        self._capacity = max(1, int(capacity))
        self._done: dict = {}
        self._next_take = 0          # the next index a worker takes
        self._next_out = 0           # the next index the consumer yields
        self._stop = False
        self._cv = threading.Condition()
        # The consumer's time blocked on a worker, in s (the main loop's
        # wait on the prefetcher).
        self.wait_s = 0.0
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(max(1, int(n_threads)))]
        for t in self._threads:
            t.start()

    # -- workers ------------------------------------------------------------
    def _load(self, i):
        inf = png.inflate(self._paths[i])
        if self._modes[i] == "unchanged" and inf.mode not in (png.GREY8,
                                                               png.GREY16):
            raise ValueError(f"{self._paths[i]}: unchanged mode takes grey "
                             f"files only")
        if self.device.type != "cpu":
            # Page-locked here, off the iterating thread: the upload then
            # only queues its copy.
            return inf, torch.from_numpy(np.ascontiguousarray(
                inf.raw)).pin_memory()
        img = png.decode_plain(inf)
        if self._modes[i] == "grey" and inf.mode == png.GREY16:
            img = np.floor(img / 256.0).astype(np.float32)
        return img

    def _work(self):
        while True:
            with self._cv:
                while (not self._stop and self._next_take < len(self._paths)
                       and self._next_take >= self._next_out
                       + self._capacity):
                    self._cv.wait()
                if self._stop or self._next_take >= len(self._paths):
                    return
                i = self._next_take
                self._next_take += 1
            try:
                res = (True, self._load(i))
            except (OSError, ValueError) as e:
                res = (False, e)
            with self._cv:
                self._done[i] = res
                self._cv.notify_all()

    # -- consumer -----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            if self._stop or self._next_out >= len(self._paths):
                raise StopIteration
            i = self._next_out
            t0 = time.perf_counter()
            while i not in self._done:
                self._cv.wait()
            self.wait_s += time.perf_counter() - t0
            ok, res = self._done.pop(i)
            self._next_out += 1
            self._cv.notify_all()
        if not ok:
            raise IOError(f"{self._paths[i]}: {res}")
        if self.device.type == "cpu":
            return i, res
        return i, self._to_device(i, res)

    def _to_device(self, i, loaded) -> torch.Tensor:
        inf, pinned = loaded
        raw = pinned.to(self.device, non_blocking=True)
        img = cuda_png.unfilter(raw, inf.width, inf.bpp, inf.mode)
        if self._modes[i] == "grey" and inf.mode == png.GREY16:
            img = torch.floor(img / 256.0)
        return img

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
