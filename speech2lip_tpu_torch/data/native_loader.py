"""The training loop's sample prefetcher (counterpart of
``speech2lip_tpu/data/native_loader.py``).

``SamplePrefetcher`` reads fixed groups of files a sample (JPEGs at a
known size, float32 ``.npy`` blobs) ahead of the consumer, on worker
threads, into a bounded ring; ``pop`` returns the samples in the epoch's
order.  Two backends serve it:

- ``"native"``: the repository's C++ runtime (``native/dataloader.cc``: a
  libjpeg decoder, a raw npy reader and a ring of worker threads, free of
  the GIL), bound by ctypes.  It is built on first use with the flags of
  ``tools/build_native.sh`` into the port's own ``build/torch_native/``.
  It needs g++ and libjpeg's headers; its IDCT may differ from OpenCV's by
  a few 1/255 steps a pixel.
- ``"threads"``: a thread pool over ``cv2`` decodes
  (``data.image_io.imread_float``) and ``np.load``, bit for bit the
  Python reader's arrays.  OpenCV is on every machine the port runs on.

``pick_backend`` takes the native runtime where it builds and loads, and
the thread pool elsewhere, as the JAX trainer takes the native runtime
where it builds; the choice is returned, and ``fit`` logs it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "dataloader.cc")
_SO_PATH = os.path.join(_REPO, "build", "torch_native",
                        "libs2l_dataloader.so")
_lib = None
_lib_error: Optional[str] = None


def _build() -> None:
    """Compile ``native/dataloader.cc`` as ``tools/build_native.sh`` does,
    into a temporary file renamed into place (concurrent builders each
    write their own)."""
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO_PATH), suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                        "-std=c++17", "-pthread", _SOURCE, "-ljpeg", "-o",
                        tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library():
    """The native runtime's ctypes handle, built on first use; raises
    OSError when it cannot be built or loaded (the reason is kept)."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise OSError(_lib_error)
    try:
        if not os.path.exists(_SO_PATH):
            _build()
        lib = ctypes.CDLL(_SO_PATH)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        _lib_error = f"native loader unavailable: {detail.strip()[:400]}"
        raise OSError(_lib_error) from None
    lib.s2l_decode_jpeg_batch.restype = ctypes.c_int
    lib.s2l_read_npy_batch.restype = ctypes.c_int
    lib.s2l_loader_create.restype = ctypes.c_void_p
    lib.s2l_loader_pop.restype = ctypes.c_int
    lib.s2l_loader_errors.restype = ctypes.c_long
    _lib = lib
    return lib


def pick_backend() -> str:
    """``"native"`` where the C++ runtime builds and loads, else
    ``"threads"``."""
    try:
        load_library()
        return "native"
    except OSError:
        return "threads"


def _sample_shapes(specs) -> List[Tuple[int, ...]]:
    return [(s[0], s[1], 3) if kind == "jpeg" else tuple(s)
            for kind, s in specs]


class _NativeRing:
    """The C++ prefetcher: worker threads fill a ring of sample slots."""

    def __init__(self, sample_files, specs, n_slots, n_threads):
        self._lib = load_library()
        jpeg = [kind == "jpeg" for kind, _ in specs]
        kinds = [0 if j else 1 for j in jpeg]
        hs = [s[0] if j else 0 for j, (_, s) in zip(jpeg, specs)]
        ws = [s[1] if j else 0 for j, (_, s) in zip(jpeg, specs)]
        self._shapes = _sample_shapes(specs)
        self._elems = elems = [int(np.prod(s)) for s in self._shapes]
        n = len(specs)
        self._floats = int(sum(elems))
        self._threads = n_threads
        joined = "\n".join("\n".join(fs) for fs in sample_files).encode()
        self._handle = self._lib.s2l_loader_create(
            len(sample_files), n, joined, (ctypes.c_int * n)(*kinds),
            (ctypes.c_int * n)(*hs), (ctypes.c_int * n)(*ws),
            (ctypes.c_int64 * n)(*elems), n_slots, n_threads)

    def start_epoch(self, order):
        arr = (ctypes.c_int * len(order))(*[int(i) for i in order])
        self._lib.s2l_loader_start(ctypes.c_void_p(self._handle), arr,
                                   len(order), self._threads)

    def pop(self):
        buf = np.empty(self._floats, np.float32)
        idx = self._lib.s2l_loader_pop(
            ctypes.c_void_p(self._handle),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if idx < 0:
            return None
        arrays, off = [], 0
        for shape, n in zip(self._shapes, self._elems):
            arrays.append(buf[off:off + n].reshape(shape).copy())
            off += n
        return idx, arrays

    @property
    def errors(self) -> int:
        return int(self._lib.s2l_loader_errors(ctypes.c_void_p(self._handle)))

    def close(self):
        if self._handle:
            self._lib.s2l_loader_destroy(ctypes.c_void_p(self._handle))
            self._handle = None


class _ThreadRing:
    """A thread pool over cv2 decodes and npy reads, at most ``n_slots``
    samples in flight.  A sample whose read fails comes back as zeros and
    counts in ``errors``, as the native ring's does."""

    def __init__(self, sample_files, specs, n_slots, n_threads):
        self._files = [list(fs) for fs in sample_files]
        self._kinds = [kind for kind, _ in specs]
        self._shapes = _sample_shapes(specs)
        self._slots = max(1, n_slots)
        self._pool = concurrent.futures.ThreadPoolExecutor(n_threads)
        self._order: List[int] = []
        self._pending: List[concurrent.futures.Future] = []
        self._next = 0
        self._errors = 0

    def _read(self, i: int):
        from speech2lip_tpu_torch.data.image_io import imread_float
        out, failed = [], False
        for path, kind, shape in zip(self._files[i], self._kinds,
                                     self._shapes):
            try:
                a = (imread_float(path) if kind == "jpeg"
                     else np.load(path).astype(np.float32))
                if a.shape != shape:
                    raise ValueError(f"{path}: {a.shape} != {shape}")
            except (OSError, ValueError):
                a, failed = np.zeros(shape, np.float32), True
            out.append(a)
        return failed, out

    def _fill(self):
        while (len(self._pending) < self._slots
               and self._next + len(self._pending) < len(self._order)):
            i = self._order[self._next + len(self._pending)]
            self._pending.append(self._pool.submit(self._read, i))

    def start_epoch(self, order):
        for f in self._pending:
            f.cancel()
        self._order = [int(i) for i in order]
        self._pending, self._next = [], 0
        self._fill()

    def pop(self):
        if self._next >= len(self._order):
            return None
        failed, arrays = self._pending.pop(0).result()
        idx = self._order[self._next]
        self._next += 1
        self._errors += int(failed)
        self._fill()
        return idx, arrays

    @property
    def errors(self) -> int:
        return self._errors

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


class SamplePrefetcher:
    """Asynchronous per-sample prefetcher over fixed file groups.

    ``sample_files``: per sample, its files; ``specs``: per file position
    ``("jpeg", (h, w))`` (decoded to float32 RGB [h, w, 3] in [0, 1]) or
    ``("npy", shape)`` (float32).  ``backend``: ``"native"``,
    ``"threads"`` or None for ``pick_backend()``; the one in use is
    ``self.backend``."""

    def __init__(self, sample_files: Sequence[Sequence[str]],
                 specs: Sequence[Tuple[str, Tuple[int, ...]]],
                 n_slots: int = 16, n_threads: int = 4,
                 backend: Optional[str] = None):
        self.backend = backend or pick_backend()
        ring = {"native": _NativeRing, "threads": _ThreadRing}[self.backend]
        self.n_samples = len(sample_files)
        self.specs = list(specs)
        self._ring = ring(sample_files, self.specs, n_slots, n_threads)

    def start_epoch(self, order: Sequence[int]):
        """Begin reading the samples ``order`` names, in that order."""
        self._ring.start_epoch(order)

    def pop(self) -> Optional[Tuple[int, List[np.ndarray]]]:
        """The next sample of the epoch, (sample index, [array per file
        spec]), or None after its last."""
        return self._ring.pop()

    @property
    def errors(self) -> int:
        return self._ring.errors

    def close(self):
        if getattr(self, "_ring", None) is not None:
            self._ring.close()
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
