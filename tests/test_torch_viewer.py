"""Port parity: the map and frame viewer without matplotlib
(``utils/viewer.py``), the RGB PNG writer and the runners'
``--snapshot-every``.

``map_geometry`` is held against what the JAX ``draw_map`` hands a
recording axis (a stub with ``scatter`` and ``plot`` that keeps its
arrays): the same points, frusta, covisibility segments and current
frustum, in the same order, within 1e-6 (float32 poses and points, the
JAX arrays in float32, the port's in float64), on the small EuRoC-mono map
with dead landmarks and a dead keyframe; its colours are matplotlib's.
The banner equals the JAX ``draw_frame``'s ``set_title``. An RGB PNG is
read back bit for bit by ``io/png`` and by OpenCV.
"""

import os

import cv2
import matplotlib.colors as mcolors
import numpy as np
import pytest
import torch
from torch_port_util import jax_map_state, n, small_map, t
from torch_runner_util import Run

from orbslam3_byzyh_tpu.utils import viewer as jviewer
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.io import png
from orbslam3_byzyh_tpu_torch.utils import viewer

TOL = 1e-6


class RecordingAxis:
    """The calls ``draw_map`` / ``draw_frame`` make on a matplotlib axis,
    with their arrays."""

    def __init__(self):
        self.scatters, self.plots, self.title = [], [], None

    def scatter(self, *xyz, **kw):
        self.scatters.append((np.stack([np.asarray(a, np.float64)
                                        for a in xyz], -1), kw))

    def plot(self, *xyz, **kw):
        self.plots.append((np.stack([np.asarray(a, np.float64)
                                     for a in xyz], -1), kw))

    def set_title(self, text, **kw):
        self.title = text

    def __getattr__(self, name):          # labels, limits, imshow, axis
        return lambda *a, **k: None


def _rgb(name):
    return tuple(int(round(255 * c)) for c in mcolors.to_rgb(name))


@pytest.fixture(scope="module")
def scene():
    """The small EuRoC-mono map (24 live keyframes), with every fifth
    landmark dead (its observation rows kept) and keyframe 3 dead."""
    st = small_map("normal").state
    lm_valid = st.lms.valid.copy()
    lm_valid[::5] = False
    kf_valid = st.kfs.valid.copy()
    kf_valid[3] = False
    st = st._replace(lms=st.lms._replace(valid=lm_valid),
                     kfs=st.kfs._replace(valid=kf_valid))
    n_kf = int(np.flatnonzero(st.kfs.valid).max()) + 1
    return st, n_kf


@pytest.mark.parametrize("max_points", [20000, 200])
def test_map_geometry_matches_draw_map(scene, max_points):
    st, n_kf = scene
    cur = (st.kfs.R[5], st.kfs.t[5] + np.float32(0.05))
    ax = RecordingAxis()
    jviewer.draw_map(jax_map_state(st), n_kf, ax=ax, current_pose=cur,
                     max_points=max_points)
    g = viewer.map_geometry(convert.map_state_to_torch(st, "cpu"), n_kf,
                            current_pose=(t(cur[0]), t(cur[1])),
                            max_points=max_points)
    (pts, kw), = ax.scatters
    np.testing.assert_allclose(g.points, pts, atol=TOL)
    assert _rgb(kw["c"]) == viewer.POINT_RGB
    plots = ax.plots
    k = len(g.keyframes)
    assert k == int(st.kfs.valid[:n_kf].sum())
    for wf, (arr, kw) in zip(g.keyframes, plots[:k]):
        np.testing.assert_allclose(wf, arr, atol=TOL)
        assert _rgb(kw["c"]) == viewer.KEYFRAME_RGB
    m = len(g.covisibility)
    assert m > 0 and len(plots) == k + m + 1
    for seg, (arr, kw) in zip(g.covisibility, plots[k:k + m]):
        np.testing.assert_allclose(seg, arr, atol=TOL)
        assert _rgb(kw["c"]) == viewer.COVIS_RGB
        assert kw["alpha"] == viewer.COVIS_ALPHA
    arr, kw = plots[-1]
    np.testing.assert_allclose(g.current, arr, atol=TOL)
    assert _rgb(kw["c"]) == viewer.CURRENT_RGB
    if max_points == 200:
        assert len(g.points) <= 200 < int(st.lms.valid.sum())


def test_render_map_draws_every_part(scene):
    st, n_kf = scene
    g = viewer.map_geometry(convert.map_state_to_torch(st, "cpu"), n_kf,
                            current_pose=(t(st.kfs.R[5]), t(st.kfs.t[5])))
    img = viewer.render_map(g, (240, 320))
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    for rgb in (viewer.POINT_RGB, viewer.KEYFRAME_RGB, viewer.CURRENT_RGB,
                viewer.BACKGROUND_RGB):
        assert rgb in colours, rgb
    empty = viewer.render_map(viewer.MapGeometry(
        np.zeros((0, 3)), np.zeros((0, 12, 3)), np.zeros((0, 2, 3)), None))
    assert (empty == 255).all()


class _Feats:
    def __init__(self, xy, valid):
        self.xy, self.valid = xy, valid


@pytest.mark.parametrize("status", [0, 1, 2, 3, 7])
def test_banner_matches_draw_frame(rng, status):
    img = rng.integers(0, 256, (60, 80)).astype(np.float32)
    xy = rng.uniform((4, 4), (75, 55), (40, 2)).astype(np.float32)
    valid = rng.random(40) < 0.9
    bind = np.where(rng.random(40) < 0.5, 3, -1).astype(np.int32)
    ax = RecordingAxis()
    jviewer.draw_frame(img, _Feats(xy, valid), bindings=bind, status=status,
                       n_kf=12, n_lm=3456, ax=ax)
    out, text = viewer.draw_frame(t(img), _Feats(t(xy), t(valid)),
                                  bindings=t(bind), status=status, n_kf=12,
                                  n_lm=3456)
    assert text == ax.title
    assert out.shape == (60 + 2 * viewer.GLYPH_H, 80, 3)
    # The banner is written, the image below it kept where no keypoint is.
    assert (out[:2 * viewer.GLYPH_H] != 255).any()
    tracked = valid & (bind >= 0)
    c = np.rint(xy[tracked][0]).astype(int)
    assert tuple(out[2 * viewer.GLYPH_H + c[1] - 3, c[0]]) == \
        viewer.COVIS_RGB


def test_write_png_rgb_round_trip(rng, tmp_path):
    a = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        path = str(tmp_path / "rgb.png")
        png.write_png(path, a, filters=filters)
        np.testing.assert_array_equal(png.read_rgb(path), a)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1], a)
    # read_grey of the same file: libpng's (cv2's) grey conversion.
    np.testing.assert_array_equal(
        png.read_grey(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError):
        png.write_png(path, a.astype(np.uint16))
    png.write_png(path, a[..., 0])
    with pytest.raises(ValueError, match="RGB"):
        png.read_rgb(path)


def test_snapshot_every_in_a_runner(tmp_path, capsys):
    """``--snapshot-every 3`` in the EuRoC stereo-inertial runner on its
    small dataset: ``map_00003.png`` and ``map_00006.png`` beside its
    other files, RGB, the last one drawing the map that the run
    initialised on its first frame."""
    run = Run("euroc_stereo_inertial", tmp_path, 6,
              extra=["--snapshot-every", "3"], capsys=capsys)
    snaps = [p for p in run.result.outputs if p.endswith(".png")]
    assert [os.path.basename(p) for p in snaps] == ["map_00003.png",
                                                    "map_00006.png"]
    assert all(os.path.dirname(p) == str(run.out) for p in snaps)
    last = png.read_rgb(snaps[-1])
    assert last.shape == (480, 640, 3)
    assert run.result.slam.n_kf > 0
    assert (last != 255).any(-1).sum() > 100


def test_view_atlas(tmp_path):
    """``scripts/view_atlas_torch.py``'s main on a checkpoint of the small
    map: the PNG and its JAX title."""
    from orbslam3_byzyh_tpu_torch.io import checkpoint
    from orbslam3_byzyh_tpu_torch.models.atlas import Atlas, MapMeta
    m = small_map("normal")
    st = convert.map_state_to_torch(m.state, "cpu")
    at = Atlas(*(x.shape[0] for x in (st.kfs.valid, st.lms.valid)),
               st.obs.kf.shape[1], st.kfs.kp_valid.shape[1], "cpu")
    at.maps = [st]
    n_kf = int(n(st.kfs.valid).nonzero()[0].max()) + 1
    at.meta = [MapMeta(n_kf, int(n(st.lms.valid).sum()), None)]
    checkpoint.save_atlas(str(tmp_path / "ck"), at)
    out = viewer.main_view_atlas([str(tmp_path / "ck"), "--out",
                                  str(tmp_path / "map.png"), "--device",
                                  "cpu"])
    img = png.read_rgb(out)
    assert img.shape == (720, 900, 3) and (img != 255).any(-1).sum() > 100
    _, title = viewer.atlas_image(at)
    assert title == (f"map 0/1: {n_kf} KFs, "
                     f"{int(n(st.lms.valid).sum())} landmarks")
    assert torch.equal(at.maps[0].kfs.R, st.kfs.R)
