"""Port parity: ``utils/timers.py`` and the systems' stage timers against
the JAX package's.

``StageTimers`` fed the same samples gives the same statistics, report
and ``ExecTimeMean.txt`` in both packages; the stage names are the same.
A short timed ``MonoSlam`` run (the chessboard cell's first frames) times
the stages the JAX system's recorded run of the same frames timed, and
with the timers off the system's ``_stage`` is a null context.
"""

import contextlib

import numpy as np
import pytest
import torch_port_util  # noqa: F401  (caps torch's threads)

from orbslam3_byzyh_tpu.utils import timers as jtimers
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys
from orbslam3_byzyh_tpu_torch.utils import timers as ttimers


def _fill(timers, samples):
    for stage, secs in samples:
        timers.samples[stage].append(secs)


def test_stage_names():
    assert ttimers.STAGES == jtimers.STAGES


def test_stats_report_and_artefact(tmp_path):
    rng = np.random.default_rng(3)
    samples = [(str(rng.choice(jtimers.STAGES)), float(rng.uniform(0, 0.2)))
               for _ in range(200)]
    a, b = jtimers.StageTimers(), ttimers.StageTimers()
    _fill(a, samples)
    _fill(b, samples)
    assert a.stats() == b.stats()
    assert a.report() == b.report()
    a.save(str(tmp_path / "jax.txt"))
    b.save(str(tmp_path / "ExecTimeMean.txt"))
    assert (tmp_path / "jax.txt").read_text() == \
        (tmp_path / "ExecTimeMean.txt").read_text()
    with b.time("lba"):
        pass
    assert b.stats()["lba"]["n"] == a.stats().get("lba", {"n": 0})["n"] + 1


def _small_config(**kw):
    """``tests/test_torch_system.py``'s world and configuration."""
    from test_torch_system import CFG
    return tsys.SlamConfig(**dict(CFG, **kw))


def test_timed_monoslam_stages_match_jax():
    """The stages a short timed run records (the snoop, the init, tracked
    frames and keyframes) are the JAX system's on the same frames: the
    chessboard cell's first 9 frames at 640x512, whose JAX run with its
    stage timers on is recorded once (``tests/chessboard_parity.py``,
    ``scripts/chessboard_parity_jax.py``) and shared with
    ``test_torch_chessboard_system.py``."""
    import chessboard_parity as cp
    f = graft.chessboard_frames()
    port = tsys.MonoSlam(cp.CFG, device="cpu")
    tp = port.enable_stage_timers()
    assert isinstance(tp, ttimers.StageTimers)
    for i in range(cp.N_FRAMES):
        port.track(f.frames_half[i], float(f.stamps[i]))
    recorded = cp.load()
    assert port.status == tsys.OK
    assert sorted(tp.samples) == recorded["stages"]
    assert {"orb_extract", "lm_track", "new_kf_decision"} <= set(tp.samples)
    assert len(tp.samples["orb_extract"]) == cp.N_FRAMES == \
        recorded["stage_counts"]["orb_extract"]
    assert "stage" in tp.report().splitlines()[0]


def test_stage_off_is_null_context():
    slam = tsys.MonoSlam(_small_config(), device="cpu")
    assert slam.timers is None
    assert isinstance(slam._stage("lm_track"), contextlib.nullcontext)
    slam.enable_stage_timers()
    with slam._stage("lm_track"):
        pass
    assert slam.timers.stats()["lm_track"]["n"] == 1


@pytest.mark.parametrize("kind", ["stereo", "fisheye"])
def test_stereo_stages(kind):
    """``graft.stereo_extract`` and ``fisheye_stereo_extract`` time their
    two stages through the caller's ``stage``."""
    import torch
    names = []

    @contextlib.contextmanager
    def stage(name):
        names.append(name)
        yield

    img = torch.tensor(graft.example_image(240, 320), dtype=torch.float32)
    cam = torch.tensor([200.0, 200.0, 160.0, 120.0])
    if kind == "stereo":
        rig = graft.RigConfig(graft.MonoConfig(
            width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
            dist=None, n_features=256), bf=40.0)
        graft.stereo_extract(img, img, cam, None, rig, stage=stage)
    else:
        rig = graft.FisheyeRigConfig(
            mono=graft.MonoConfig(width=320, height=240, fx=200.0, fy=200.0,
                                  cx=160.0, cy=120.0, dist=None,
                                  n_features=256),
            cam2=(200.0, 200.0, 160.0, 120.0), kb8=None, kb8_2=None,
            dist2=None, R_rl=np.eye(3, dtype=np.float32),
            t_rl=np.array([-0.2, 0.0, 0.0], np.float32), bf=40.0)
        graft.fisheye_stereo_extract(img, img, rig, stage=stage)
    assert names == ["orb_extract", "stereo_match"]
