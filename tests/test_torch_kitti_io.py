"""The port's KITTI-layout I/O (limo_tpu_torch.io) against the reference
package's and against PIL, on the CPU.

- The PNG codec (``io/png.py``): files written by PIL (adaptive row
  filters) and files carrying each of the five row filters decode to PIL's
  pixels bit for bit; files the port writes decode, in PIL and in the port,
  to the pixels written. Tolerance: none (bit-exact).
- ``write_kitti_sequence`` (port, through its codec) and the reference's
  (through PIL) write the same sequence: the same calibration, stamps,
  poses and scans byte for byte, and images and labels that both
  packages' readers load to the same arrays.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from limo_tpu.io import kitti as jkitti
from limo_tpu.pipeline import render as jrender
from limo_tpu.pipeline.synthetic import make_world as jmake_world
from limo_tpu_torch.io import kitti as tkitti
from limo_tpu_torch.io.png import read_png, write_png
from limo_tpu_torch.pipeline import render as trender
from limo_tpu_torch.pipeline.synthetic import make_world as tmake_world


def _images(rng):
    """A noisy image, a smooth gradient, constant rows and a label map."""
    noise = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    yy, xx = np.mgrid[0:40, 0:64]
    grad = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    const = np.full((7, 9), 200, np.uint8)
    labels = np.where(xx + yy > 50, 26, 7).astype(np.uint8)
    return {"noise": noise, "gradient": grad, "constant": const,
            "labels": labels}


def _filtered_png(path, img, filt):
    """An 8-bit grayscale PNG whose every row carries filter type ``filt``
    (the PNG specification's filters, written here independently of the
    port's decoder)."""
    h, w = img.shape
    rows, prior = [], np.zeros(w, np.int64)
    for y in range(h):
        cur = img[y].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        if filt == 0:
            pred = np.zeros(w, np.int64)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([filt]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prior = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["noise", "gradient", "constant", "labels"])
def test_png_reads_pil_written(tmp_path, kind):
    img = _images(np.random.default_rng(5))[kind]
    path = str(tmp_path / "pil.png")
    Image.fromarray(img).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_reads_every_row_filter(tmp_path, filt):
    img = _images(np.random.default_rng(6))["noise"]
    path = str(tmp_path / f"filter{filt}.png")
    _filtered_png(path, img, filt)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("kind", ["noise", "gradient", "constant", "labels"])
def test_png_written_reads_back(tmp_path, kind):
    img = _images(np.random.default_rng(7))[kind]
    path = str(tmp_path / "port.png")
    write_png(path, img)
    pil = Image.open(path)
    assert pil.mode == "L"
    np.testing.assert_array_equal(np.asarray(pil), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_rejects_other_formats(tmp_path):
    path = str(tmp_path / "rgb.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(path)
    with pytest.raises(ValueError):
        read_png(path)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 5), np.float32))


def test_write_kitti_sequence_matches_reference(tmp_path):
    """Both packages' writers on one world and cloud seed, both packages'
    readers on both directories."""
    kw = dict(num_frames=4, speed=6.0, yaw_rate=0.012, n_landmarks=60,
              n_ground=20, n_shrubbery=6, n_dynamic=4, dynamic_speed=6.0,
              seed=9, focal=450.0, pp=(128.0, 48.0), image_size=(256, 96))
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    gts = {"ref": jrender.write_kitti_sequence(
               roots["ref"], jmake_world(**kw), 4, np.random.default_rng(42)),
           "port": trender.write_kitti_sequence(
               roots["port"], tmake_world(**kw), 4,
               np.random.default_rng(42))}
    for name in ("calib.txt", "times.txt", "gt.txt"):
        with open(os.path.join(roots["ref"], name), "rb") as a, \
                open(os.path.join(roots["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    seqs = {(pkg, which): mod.KittiSequence.open(roots[which], gts[which])
            for pkg, mod in (("ref", jkitti), ("port", tkitti))
            for which in roots}
    base = seqs[("ref", "ref")]
    assert base.has_labels and len(base) == 4
    for key, seq in seqs.items():
        np.testing.assert_array_equal(seq.times, base.times, err_msg=key)
        np.testing.assert_array_equal(seq.poses_gt, base.poses_gt,
                                      err_msg=key)
        np.testing.assert_array_equal(seq.calib.Tr_cam_velo,
                                      base.calib.Tr_cam_velo, err_msg=key)
        assert seq.calib.focal == base.calib.focal
        np.testing.assert_array_equal(seq.calib.principal,
                                      base.calib.principal)
        for i in range(4):
            img, lab = seq.load_image(i), seq.load_labels(i)
            assert img.dtype == np.float32 and lab.dtype == np.int32
            np.testing.assert_array_equal(img, base.load_image(i),
                                          err_msg=f"{key} image {i}")
            np.testing.assert_array_equal(lab, base.load_labels(i),
                                          err_msg=f"{key} labels {i}")
            np.testing.assert_array_equal(seq.load_velodyne(i),
                                          base.load_velodyne(i))


def test_poses_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    poses7 = np.concatenate([np.ones((5, 1)), rng.normal(0, 0.1, (5, 3)),
                             rng.normal(0, 5, (5, 3))], 1)
    poses7[:, :4] /= np.linalg.norm(poses7[:, :4], axis=1, keepdims=True)
    mats = tkitti.pose7_to_kitti(poses7)
    np.testing.assert_array_equal(mats, jkitti.pose7_to_kitti(poses7))
    tkitti.write_poses(str(tmp_path / "p.txt"), mats)
    jkitti.write_poses(str(tmp_path / "q.txt"), mats)
    assert open(tmp_path / "p.txt").read() == open(tmp_path / "q.txt").read()
    np.testing.assert_array_equal(tkitti.read_poses(str(tmp_path / "p.txt")),
                                  jkitti.read_poses(str(tmp_path / "q.txt")))
