"""Port parity: ``io/settings.py`` (its own reader of OpenCV's YAML 1.0)
against the JAX package's ``load_settings`` (``cv2.FileStorage``).

Every calibration file in ``configs/`` reads the same in both packages,
field by field (the arrays' dtypes and values equal). ``tests/test_io.py``'s
chessboard-key cases are replayed on a temporary file. The reader's node
typing (strings, numbers, matrices, sequences and maps that are no
matrix) is held to ``cv2.FileStorage`` on a file of each kind, and the
port's constants for ``configs/Mycamera.yaml`` (``graft.MYCAMERA_MONO``)
to the file.
"""

import dataclasses
import glob
import os

import cv2
import numpy as np
import pytest

from orbslam3_byzyh_tpu.io import settings as jset
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.io import settings as tset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _same(a, b, path):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_thirteen_configs():
    assert len(CONFIGS) == 13
    assert tset.CONFIG_DIR == (tset.CONFIG_DIR.parent / "configs")
    assert sorted(str(p) for p in tset.CONFIG_DIR.glob("*.yaml")) == CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_settings_equals_jax(path):
    _same(jset.load_settings(path), tset.load_settings(path),
          os.path.basename(path))


CB_YAML = """%YAML:1.0
---
Camera.type: "PinHole"
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.width: 640
Camera.height: 480
Camera.fps: 30
UseChessboardInit: 1
ChessboardWidth: 11
ChessboardHeight: 8
SquareSize: 0.03
StartX: 0.1
StartY: 0.2
ZHeight: 0.5
"""


def test_chessboard_keys_parsed(tmp_path):
    """``test_io.TestChessboardSettings.test_chessboard_keys_parsed``."""
    p = str(tmp_path / "cb.yaml")
    open(p, "w").write(CB_YAML)
    s = tset.load_settings(p)
    cb = s.chessboard
    assert cb is not None
    assert (cb.width, cb.height) == (11, 8)
    assert abs(cb.square_size - 0.03) < 1e-9
    assert (cb.start_x, cb.start_y, cb.z_height) == (0.1, 0.2, 0.5)
    _same(jset.load_settings(p), s, "cb.yaml")


@pytest.mark.parametrize("value", ['"true"', '"off"', "0"])
def test_chessboard_switch(tmp_path, value):
    """The switch as a string or a number; absent by default
    (``test_chessboard_absent_by_default`` on a file without the keys)."""
    p = str(tmp_path / "cb.yaml")
    open(p, "w").write(CB_YAML.replace("UseChessboardInit: 1",
                                       f"UseChessboardInit: {value}"))
    _same(jset.load_settings(p), tset.load_settings(p), value)
    plain = str(tmp_path / "plain.yaml")
    open(plain, "w").write(CB_YAML.split("UseChessboardInit")[0])
    assert tset.load_settings(plain).chessboard is None
    assert jset.load_settings(plain).chessboard is None


NODES = """%YAML:1.0
---
A: [1, 2, 3]
B:
  x: 1
  y: 2
C: !!opencv-matrix
  rows: 2
  cols: 3
  dt: d
  data: [1, 2.5, -3e-2,
         4, .5, 6.]
D: hello
E: "1.0"
F: 1e-3
G: -.5
H: 7 # a comment
I: 'single # quoted'
J: true
K: 0x10
M: !!opencv-matrix
   rows: 1
   cols: 2
   dt: i
   data: [3, -4]
"""


def test_node_typing_as_filestorage(tmp_path):
    """Each node as the JAX ``_read`` sees it through ``cv2.FileStorage``:
    a string, a float, a matrix of its dtype, or None for a sequence or a
    map that is no matrix; a missing key takes its default or raises."""
    p = str(tmp_path / "nodes.yaml")
    open(p, "w").write(NODES)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    mine = tset.FileStorage(p)
    try:
        for key in "ABCDEFGHIJKM":
            a, b = jset._read(fs, key), tset._read(mine, key)
            if isinstance(a, np.ndarray):
                _same(a, b, key)
            else:
                assert type(a) is type(b) and a == b, (key, a, b)
        assert tset._read(mine, "Z", 3.0) == jset._read(fs, "Z", 3.0) == 3.0
        with pytest.raises(KeyError):
            tset._read(mine, "Z", required=True)
    finally:
        fs.release()
    with pytest.raises(FileNotFoundError):
        tset.load_settings(str(tmp_path / "missing.yaml"))


def test_mycamera_constants():
    """``graft.MYCAMERA_MONO`` and its board are the file's values."""
    s = tset.load_settings(tset.CONFIG_DIR / "Mycamera.yaml")
    e = graft.MYCAMERA_MONO
    assert (e.width, e.height) == (s.cam1.width, s.cam1.height)
    np.testing.assert_array_equal(
        np.array([e.fx, e.fy, e.cx, e.cy], np.float32), s.cam1.params)
    np.testing.assert_array_equal(np.array(e.dist, np.float32),
                                  s.cam1.dist[:4])
    assert s.cam1.dist[4] == 0.0
    assert (e.n_features, e.n_levels, e.scale) == (
        s.orb.n_features, s.orb.n_levels, s.orb.scale_factor)
    assert graft.MYCAMERA_FAST == (s.orb.ini_th_fast, s.orb.min_th_fast)
    assert graft.MYCAMERA_FPS == s.fps
    assert dataclasses.asdict(graft.MYCAMERA_BOARD) == \
        dataclasses.asdict(s.chessboard)
    assert (e.max_kf, e.max_lm, e.max_obs) == (1024, 65536, 12)
