"""The port's sample prefetcher (speech2lip_tpu_torch.data.native_loader)
and the training loop's use of it, on the CPU.

Both backends against the Python reader (``LipDataset.load_frame``) on a
synthetic identity: the thread pool decodes with cv2 as the reader does,
so its batches are equal bit for bit; the native runtime decodes with
libjpeg, within the JAX package's 3/255 (tests/test_train_e2e.py) of
cv2's pixels, and equals the JAX package's own binding of the same
runtime bit for bit.
"""

import os

import numpy as np
import pytest

from speech2lip_tpu_torch.data import native_loader as nl
from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.data.dataset import LipDataset
from speech2lip_tpu_torch.train import trainer


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader") / "tree")
    cfg = tsyn.synthetic_config(root, tsyn.make_synthetic_tree(
        root, n_frames=9, face=48, lip_h=16, lip_w=24))
    cfg["training"]["use_syncloss"] = False
    return LipDataset(root, "train", cfg)


def _epoch(ds, monkeypatch, backend, **kw):
    if backend is not None:
        monkeypatch.setattr(nl, "pick_backend", lambda: backend)
    return list(trainer.batch_iterator(ds, 2, shuffle=True, seed=3,
                                       use_native=backend is not None, **kw))


def test_thread_backend_equals_the_python_reader(ds, monkeypatch):
    ref = _epoch(ds, monkeypatch, None)
    got = _epoch(ds, monkeypatch, "threads")
    assert len(ref) == len(got) == len(ds) // 2
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_native_backend_within_jpeg_rounding(ds, monkeypatch):
    if nl.pick_backend() != "native":
        pytest.fail(f"the native runtime must build here: {nl._lib_error}")
    ref = _epoch(ds, monkeypatch, None)
    got = _epoch(ds, monkeypatch, "native")
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k in a:
            tol = 3.0 / 255.0 if k in ("rgb", "rgb_face_ori") else 0.0
            assert float(np.abs(a[k] - b[k]).max()) <= tol, k


def test_native_backend_equals_the_jax_binding(ds):
    from speech2lip_tpu.data.native_loader import SamplePrefetcher as JPre
    files = [[os.path.join(ds.images_dir, ds.files[i]),
              os.path.join(ds.faces_dir, ds.files[i]),
              os.path.join(ds.coords_dir, ds.coord_files[i])]
             for i in ds._index_map]
    specs = [("jpeg", (ds.lip_h, ds.lip_w)), ("jpeg", (ds.face_h, ds.face_w)),
             ("npy", (ds.face_h, ds.face_w, 2))]
    order = [4, 0, 3, 1]
    ours = nl.SamplePrefetcher(files, specs, backend="native")
    theirs = JPre(files, specs)
    for p in (ours, theirs):
        p.start_epoch(order)
    for _ in order:
        (i, a), (j, b) = ours.pop(), theirs.pop()
        assert i == j and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert ours.pop() is None and ours.errors == theirs.errors == 0
    ours.close()
    theirs.close()


@pytest.mark.parametrize("backend", ["threads", "native"])
def test_prefetcher_interface(ds, tmp_path, backend):
    """Samples in the epoch's order, None after the last, a new epoch
    restarts the order, and a file that cannot be read counts as an
    error and comes back as zeros."""
    good = [os.path.join(ds.faces_dir, f) for f in ds.files[:3]]
    files = [[good[0]], [str(tmp_path / "missing.jpg")], [good[2]]]
    p = nl.SamplePrefetcher(files, [("jpeg", (ds.face_h, ds.face_w))],
                            n_slots=2, n_threads=2, backend=backend)
    assert p.backend == backend
    p.start_epoch([2, 1, 0])
    got = [p.pop() for _ in range(3)]
    assert [g[0] for g in got] == [2, 1, 0] and p.pop() is None
    assert p.errors == 1 and not got[1][1][0].any()
    assert got[0][1][0].shape == (ds.face_h, ds.face_w, 3)
    p.start_epoch([0])
    i, (a,) = p.pop()
    assert i == 0 and np.array_equal(a, got[2][1][0])
    p.close()


def test_the_sync_stage_and_use_native_false_read_in_python(ds,
                                                            monkeypatch):
    assert trainer.prefetch_backend(ds, use_native=False) is None
    monkeypatch.setattr(ds, "use_syncloss", True)
    assert trainer.prefetch_backend(ds) is None
    monkeypatch.setattr(ds, "use_syncloss", False)
    assert trainer.prefetch_backend(ds) in ("native", "threads")
