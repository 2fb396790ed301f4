"""Typed settings reader for the YAML calibration files in ``configs/``.

Port of the JAX package's ``io/settings.py`` (ORB-SLAM3's ``Settings``,
calibration format "1.0", and the legacy per-section keys of
``Tracking::ParseCamParamFile``): the same dataclasses and the same values
for the same file. The files carry OpenCV's ``%YAML:1.0`` directive, which
plain YAML parsers reject; the JAX package reads them with
``cv2.FileStorage``, and the card's machine has no OpenCV, so this module
holds its own reader of the subset of OpenCV's YAML 1.0 the files use:
the directive and ``---``, block mappings, ``#`` comments, quoted and plain
scalars, flow sequences (over several lines) and ``!!opencv-matrix`` maps
(rows, cols, dt, data). A scalar that parses as a number is a number (an
int, a hex int, ``true`` / ``false`` as 1 / 0, or a real), anything else a
string, as ``FileStorage`` types it.

``configs/`` lies at the repo root, outside both packages: the port reads
it by path (:data:`CONFIG_DIR`), as it reads ``vocabulary/``.

Known reference bug not replicated (the JAX package's choice, kept):
``Settings::camera2DistortionCoef`` returns camera1's distortion; camera2's
own is read.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

import numpy as np

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


@dataclasses.dataclass
class CameraSettings:
    model: str                      # "PinHole" | "KannalaBrandt8" | "Rectified"
    params: np.ndarray              # [fx, fy, cx, cy, (+k0..k3 for KB8)]
    dist: Optional[np.ndarray]      # radtan [k1,k2,p1,p2,(k3)] or None
    width: int
    height: int


@dataclasses.dataclass
class ImuSettings:
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    frequency: float
    Tbc: np.ndarray                 # (4, 4) body<-camera


@dataclasses.dataclass
class OrbSettings:
    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class ChessboardSettings:
    """The fork's chessboard world-frame keys (read in its Tracking
    constructor)."""
    width: int
    height: int
    square_size: float
    start_x: float = 0.0
    start_y: float = 0.0
    z_height: float = 0.0


@dataclasses.dataclass
class SlamSettings:
    cam1: CameraSettings
    cam2: Optional[CameraSettings]
    imu: Optional[ImuSettings]
    orb: OrbSettings
    fps: float
    rgb: bool
    bf: Optional[float] = None      # stereo baseline*fx
    th_depth: Optional[float] = None
    Tlr: Optional[np.ndarray] = None
    chessboard: Optional[ChessboardSettings] = None
    # Atlas persistence (System.SaveAtlasToFile / LoadAtlasFromFile).
    save_atlas: Optional[str] = None
    load_atlas: Optional[str] = None


# --- OpenCV YAML 1.0 ----------------------------------------------------------

class MatrixError(ValueError):
    """A map or sequence that is no ``!!opencv-matrix`` (``FileNode.mat()``
    raises ``cv2.error`` there)."""


class Matrix(dict):
    """A map node tagged ``!!opencv-matrix``."""


_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
       "i": np.int32, "f": np.float32, "d": np.float64}
_INT = re.compile(r"[+-]?(0[xX][0-9a-fA-F]+|\d+)$")
_REAL = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                   r"|\.(inf|Inf|INF)|\.(nan|NaN|NAN))$")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    """A plain or quoted scalar: a str, an int or a float."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    if s == "":
        return "..."                 # FileStorage's empty scalar
    if s in ("true", "True", "TRUE"):
        return 1
    if s in ("false", "False", "FALSE"):
        return 0
    if _INT.match(s):
        return int(s, 0) if not re.match(r"[+-]?0\d", s) else int(s, 10)
    if _REAL.match(s):
        low = s.lower().lstrip("+-")
        if low == ".inf":
            return float("-inf") if s.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(s)
    return s


def _flow_seq(text: str) -> list:
    """The items of ``[a, b, ...]`` (flat: the files nest none)."""
    body = text.strip()[1:-1]
    return [_scalar(x) for x in body.split(",") if x.strip() != ""]


def parse_opencv_yaml(text: str) -> dict:
    """The top-level map of an OpenCV YAML 1.0 document: str -> node, a
    node being a str, an int, a float, a list (a sequence), a dict (a map)
    or a :class:`Matrix`."""
    lines = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending += " " + line.strip()
            if pending.count("[") <= pending.count("]"):
                lines.append(pending)
                pending = None
            continue
        if not line.strip() or line.startswith("%") or \
                line.strip() in ("---", "..."):
            continue
        if line.count("[") > line.count("]"):
            pending = line
            continue
        lines.append(line)
    if pending is not None:
        raise ValueError("unterminated flow sequence")

    def indent(s):
        return len(s) - len(s.lstrip(" "))

    def block(i: int, level: int):
        out = {}
        while i < len(lines) and indent(lines[i]) >= level:
            line = lines[i]
            key, sep, rest = line.strip().partition(":")
            if not sep:
                raise ValueError(f"not a mapping line: {line!r}")
            key = _scalar(key) if key.strip()[:1] in "\"'" else key.strip()
            rest = rest.strip()
            tag = None
            if rest.startswith("!!"):
                tag, _, rest = rest.partition(" ")
                rest = rest.strip()
            i += 1
            if rest == "" and i < len(lines) and indent(lines[i]) > indent(
                    line):
                node, i = block(i, indent(lines[i]))
                if tag == "!!opencv-matrix":
                    node = Matrix(node)
            elif rest.startswith("["):
                node = _flow_seq(rest)
            else:
                node = _scalar(rest)
            out[str(key)] = node
        return out, i

    doc, i = block(0, 0)
    if i != len(lines):
        raise ValueError(f"unparsed line: {lines[i]!r}")
    return doc


def node_matrix(node) -> np.ndarray:
    """``FileNode.mat()``: the array of an ``!!opencv-matrix`` map (or of a
    map with its keys), else :class:`MatrixError`."""
    if not isinstance(node, dict) or not {"rows", "cols", "dt",
                                          "data"} <= set(node):
        raise MatrixError("not a matrix")
    dt = str(node["dt"])
    data = node["data"]
    if not isinstance(data, list) or dt not in _DT:
        raise MatrixError(f"matrix of dt {dt!r}")
    rows, cols = int(node["rows"]), int(node["cols"])
    if len(data) != rows * cols:
        raise MatrixError(f"{len(data)} values for {rows} x {cols}")
    return np.asarray(data, np.float64).astype(_DT[dt]).reshape(rows, cols)


class FileStorage:
    """The read half of ``cv2.FileStorage`` over a parsed document."""

    def __init__(self, path):
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(str(path))
        self.nodes = parse_opencv_yaml(path.read_text())

    def get(self, key: str):
        return self.nodes.get(key)


def _read(fs: FileStorage, key, default=None, required=False):
    """The JAX package's ``_read``: the default for a missing key (or a
    KeyError if required), a string as a string, a map or sequence as its
    matrix (None where it is none), every number as a float."""
    node = fs.get(key)
    if node is None:
        if required:
            raise KeyError(f"missing required setting {key}")
        return default
    if isinstance(node, str):
        return node
    if isinstance(node, (dict, list)):
        try:
            return node_matrix(node)
        except MatrixError:
            return None
    return float(node)


def _read_camera(fs, idx: int, fallback_size=None) -> Optional[CameraSettings]:
    prefix = f"Camera{idx}"
    cam_type = _read(fs, f"{prefix}.type") or _read(fs, "Camera.type")
    fx = _read(fs, f"{prefix}.fx")
    if fx is None and idx == 1:
        # Legacy single-camera format (Camera.fx ...).
        prefix = "Camera"
        fx = _read(fs, "Camera.fx")
        cam_type = cam_type or "PinHole"
    if fx is None:
        return None
    fy = _read(fs, f"{prefix}.fy", required=True)
    cx = _read(fs, f"{prefix}.cx", required=True)
    cy = _read(fs, f"{prefix}.cy", required=True)
    w = _read(fs, "Camera.width") or _read(fs, "Camera1.width") or 0
    h = _read(fs, "Camera.height") or _read(fs, "Camera1.height") or 0
    w = int(w or (fallback_size or (0, 0))[0])
    h = int(h or (fallback_size or (0, 0))[1])

    if cam_type and "KannalaBrandt" in str(cam_type):
        ks = [_read(fs, f"{prefix}.k{i}", 0.0) for i in range(1, 5)]
        params = np.array([fx, fy, cx, cy, *ks], np.float32)
        return CameraSettings("KannalaBrandt8", params, None, w, h)

    dist_keys = ["k1", "k2", "p1", "p2", "k3"]
    dist = [_read(fs, f"{prefix}.{k}") for k in dist_keys]
    if dist[0] is None:
        dist_arr = None
    else:
        dist_arr = np.array([d or 0.0 for d in dist], np.float32)
        if abs(dist_arr).sum() == 0:
            dist_arr = None
    params = np.array([fx, fy, cx, cy], np.float32)
    return CameraSettings(str(cam_type or "PinHole"), params, dist_arr, w, h)


def load_settings(path) -> SlamSettings:
    """The settings of the calibration file at ``path``."""
    fs = FileStorage(path)
    cam1 = _read_camera(fs, 1)
    if cam1 is None:
        raise KeyError(f"no camera intrinsics in {path}")
    cam2 = _read_camera(fs, 2, fallback_size=(cam1.width, cam1.height))

    imu = None
    ng = _read(fs, "IMU.NoiseGyro")
    if ng is not None:
        freq = float(_read(fs, "IMU.Frequency", 200.0))
        Tbc = _read(fs, "IMU.T_b_c1")
        if Tbc is None:
            Tbc = _read(fs, "Tbc")
        imu = ImuSettings(
            noise_gyro=float(ng),
            noise_acc=float(_read(fs, "IMU.NoiseAcc", 0.0)),
            walk_gyro=float(_read(fs, "IMU.GyroWalk", 0.0)),
            walk_acc=float(_read(fs, "IMU.AccWalk", 0.0)),
            frequency=freq,
            Tbc=np.asarray(Tbc, np.float64) if Tbc is not None else np.eye(4))

    orb = OrbSettings(
        n_features=int(_read(fs, "ORBextractor.nFeatures", 1200)),
        scale_factor=float(_read(fs, "ORBextractor.scaleFactor", 1.2)),
        n_levels=int(_read(fs, "ORBextractor.nLevels", 8)),
        ini_th_fast=int(_read(fs, "ORBextractor.iniThFAST", 20)),
        min_th_fast=int(_read(fs, "ORBextractor.minThFAST", 7)))

    fps = float(_read(fs, "Camera.fps", 30.0))
    rgb = bool(int(_read(fs, "Camera.RGB", 1)))
    bf = _read(fs, "Camera.bf")
    if bf is None:
        # Rectified-pair configs give the metric baseline instead
        # (Stereo.b; bf = b * fx).
        b = _read(fs, "Stereo.b")
        if b is not None:
            bf = float(b) * float(cam1.params[0])
    th_depth = _read(fs, "Camera.ThDepth") or _read(fs, "Stereo.ThDepth")
    Tlr = _read(fs, "Stereo.T_c1_c2")
    if Tlr is None:
        # Legacy 3x4 left->right key (Stereo.Tlr / Tlr, TUM-VI yamls).
        Tlr = _read(fs, "Stereo.Tlr")
        if Tlr is None:
            Tlr = _read(fs, "Tlr")
    if Tlr is not None:
        Tlr = np.asarray(Tlr, np.float64)
        if Tlr.shape == (3, 4):
            Tlr = np.vstack([Tlr, [0.0, 0.0, 0.0, 1.0]])

    chessboard = None
    use_cb = _read(fs, "UseChessboardInit")
    if isinstance(use_cb, str):
        use_cb = use_cb.strip().lower() in ("1", "true", "yes", "on")
    if use_cb:
        chessboard = ChessboardSettings(
            width=int(_read(fs, "ChessboardWidth", 9)),
            height=int(_read(fs, "ChessboardHeight", 6)),
            square_size=float(_read(fs, "SquareSize", 0.025)),
            start_x=float(_read(fs, "StartX", 0.0)),
            start_y=float(_read(fs, "StartY", 0.0)),
            z_height=float(_read(fs, "ZHeight", 0.0)))

    save_atlas = _read(fs, "System.SaveAtlasToFile")
    load_atlas = _read(fs, "System.LoadAtlasFromFile")

    return SlamSettings(
        cam1=cam1, cam2=cam2, imu=imu, orb=orb, fps=fps, rgb=rgb,
        bf=float(bf) if bf is not None else None,
        th_depth=float(th_depth) if th_depth is not None else None,
        Tlr=np.asarray(Tlr, np.float64) if Tlr is not None else None,
        chessboard=chessboard,
        save_atlas=str(save_atlas) if save_atlas else None,
        load_atlas=str(load_atlas) if load_atlas else None)
