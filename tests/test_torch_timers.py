"""Port parity: ``utils/timers.py`` and the systems' stage timers against
the JAX package's.

``StageTimers`` fed the same samples gives the same statistics, report
and ``ExecTimeMean.txt`` in both packages; the stage names are the same.
A short timed ``MonoSlam`` run (``tests/test_torch_system.py``'s world and
configuration) times the stages the JAX system's run times, and with the timers off the
system's ``_stage`` is a null context.
"""

import contextlib

import numpy as np
import pytest
import torch_port_util  # noqa: F401  (caps torch's threads)

from orbslam3_byzyh_tpu.pipeline import system as jsys
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


def _frames(n):
    from synth_world import SynthWorld
    from test_torch_system import F, H, STAMPS, W
    world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F)
    return ([world.render(float(t)).astype(np.uint8) for t in STAMPS[:n]],
            STAMPS[:n])


def test_timed_monoslam_stages_match_jax():
    """The stages a short timed run records (the init, tracked frames and
    keyframes) are the JAX system's on the same frames."""
    import dataclasses
    import jax
    from orbslam3_byzyh_tpu.ops import geometry as jgeo
    frames, stamps = _frames(9)          # the map is made on frame 7
    cfg = _small_config()
    port = tsys.MonoSlam(cfg, device="cpu")
    jax_ = jsys.MonoSlam(jsys.SlamConfig(**dict(
        dataclasses.asdict(cfg), device_mesh=False)))
    tp, tj = port.enable_stage_timers(), jax_.enable_stage_timers()
    assert isinstance(tp, ttimers.StageTimers)
    two_view = jgeo.two_view_reconstruct
    jgeo.two_view_reconstruct = jax.jit(two_view)
    try:
        for img, s in zip(frames, stamps):
            port.track(img, float(s))
            jax_.track(img, float(s))
    finally:
        jgeo.two_view_reconstruct = two_view
    assert port.status == jax_.status == tsys.OK
    assert set(tp.samples) == set(tj.samples)
    assert {"orb_extract", "lm_track", "new_kf_decision"} <= set(tp.samples)
    assert len(tp.samples["orb_extract"]) == len(frames)
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
