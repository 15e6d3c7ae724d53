"""The port's ctypes loader of the C++ runtime (``limo_tpu_torch.io.
native_loader``): velodyne reads against numpy, and the C++ track table
against the port's ``TrackletBuilder`` and the reference package's
``NativeTrackTable``. Skips only where ``g++`` is absent (the loader then
reads with numpy), as ``tests/test_native.py`` does without its library."""

import shutil

import numpy as np
import pytest

from limo_tpu.io import native_loader as j_native
from limo_tpu_torch.io import kitti, native_loader
from limo_tpu_torch.pipeline.tracklets import TrackletBuilder


@pytest.fixture(autouse=True)
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ absent: the loader reads with numpy")
    lib = native_loader.get_lib()
    assert lib is not None
    return lib


def test_library_built_into_the_build_tree(lib):
    path = native_loader.library_path()
    assert path.exists() and path.parent.name == "limo_tpu_torch"
    assert path.parent.parent.name == "build"


def test_read_matches_numpy(tmp_path, rng):
    pts = rng.normal(size=(1234, 4)).astype(np.float32)
    p = tmp_path / "000000.bin"
    pts.tofile(p)
    before = dict(native_loader.reads)
    np.testing.assert_array_equal(native_loader.read_velodyne(str(p)), pts)
    np.testing.assert_array_equal(kitti.read_velodyne(str(p)), pts)
    assert native_loader.reads["native"] == before["native"] + 2
    assert native_loader.reads["numpy"] == before["numpy"]
    with pytest.raises(FileNotFoundError):
        native_loader.read_velodyne(str(tmp_path / "missing.bin"))


def test_batch(tmp_path, rng):
    paths, ref = [], []
    for i in range(5):
        pts = rng.normal(size=(100 + 150 * i, 4)).astype(np.float32)
        p = tmp_path / f"{i:06d}.bin"
        pts.tofile(p)
        paths.append(str(p))
        ref.append(pts)
    out, counts = native_loader.read_velodyne_batch(paths, 512)
    for i in range(5):
        n = min(ref[i].shape[0], 512)
        assert counts[i] == n
        np.testing.assert_array_equal(out[i, :n], ref[i][:n])
        assert (out[i, n:] == 0).all()


def _frames(rng):
    uv0 = rng.uniform(0, 100, (6, 2))
    uv1 = np.vstack([uv0[1:4] + 1.0, rng.uniform(0, 100, (2, 2))])
    uv2 = np.vstack([uv1[:4] + 0.5, rng.uniform(0, 100, (1, 2))])
    return [(0.0, uv0, None, np.array([1.5, -1.0, 3.0, 2.0, -1.0, 4.0])),
            (0.1, uv1, np.array([1, 2, 3, -1, -1]), None),
            (0.2, uv2, np.array([0, 1, 2, 3, -1]), rng.uniform(1, 9, 5)),
            (0.3, rng.uniform(0, 100, (2, 2)), None, None)]


@pytest.mark.parametrize("max_len", [3, 10])
def test_track_table_matches_builder_and_reference(rng, max_len):
    """The same pushes through the C++ table (the port's and the
    reference's bindings) and the port's TrackletBuilder: equal tracks,
    stamps, masks and (u, v, d) per track id."""
    frames = _frames(rng)
    py = TrackletBuilder(max_track_length=max_len)
    nat = native_loader.NativeTrackTable(max_track_length=max_len)
    ref = j_native.NativeTrackTable(max_track_length=max_len)
    for frame in frames:
        for table in (py, nat, ref):
            table.push_frame(*frame)
    t_py, t_nat, t_ref = (t.to_tracklets() for t in (py, nat, ref))
    for field in ("stamps", "uvd", "mask", "ids", "age", "is_outlier",
                  "label"):
        np.testing.assert_array_equal(getattr(t_nat, field),
                                      getattr(t_ref, field), field)
    assert t_nat.num_tracks == t_py.num_tracks
    np.testing.assert_allclose(t_nat.stamps, t_py.stamps)
    for tid in t_py.ids:
        r_py = np.flatnonzero(t_py.ids == tid)[0]
        r_nat = np.flatnonzero(t_nat.ids == tid)[0]
        np.testing.assert_array_equal(t_nat.mask[r_nat], t_py.mask[r_py])
        m = t_py.mask[r_py]
        np.testing.assert_allclose(t_nat.uvd[r_nat][m], t_py.uvd[r_py][m],
                                   atol=1e-5)


def test_push_checks_shapes(rng):
    table = native_loader.NativeTrackTable()
    with pytest.raises(ValueError):
        table.push_frame(0.0, rng.uniform(0, 1, (4, 3)))
    with pytest.raises(ValueError):
        table.push_frame(0.0, rng.uniform(0, 1, (4, 2)), depth=np.ones(3))
