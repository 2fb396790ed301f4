"""Port parity: ``io/checkpoint.py`` and the systems'
``save_atlas_checkpoint`` / ``load_atlas_checkpoint`` against the JAX
package's.

The two packages share the on-disk format (format version 2: one
``map_<i>.npz`` a map with ``kfs.*``, ``lms.*``, ``obs.*`` and
``meta.kf_parent``, and a ``manifest.json`` with each file's SHA-256;
descriptors as uint32 words). Atlases of random maps
(``test_torch_atlas_merge.random_map``: every field drawn, descriptors over
the whole 32-bit range) make a round trip in the port, and cross between
the packages both ways, with every array, counter, spanning tree and the
current index equal. A changed byte or version is refused. A system that
loads a checkpoint rebuilds each loaded map's database (the port in one
``add_range`` a map) equal to the JAX system's and starts a fresh active
map.
"""

import json
import os

import numpy as np
import pytest
from test_torch_atlas_merge import random_map
from torch_port_util import jax_map_state

from orbslam3_byzyh_tpu.io import checkpoint as jck
from orbslam3_byzyh_tpu.models import atlas as jatlas
from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.io import checkpoint as tck
from orbslam3_byzyh_tpu_torch.ops import bow as tbow
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

DIMS = (16, 256, 4, 64)


def _maps(seed, n=3):
    rng = np.random.default_rng(seed)
    return [random_map(rng, DIMS, 5 + 3 * i, 60 + 40 * i, tree=i != 1)
            for i in range(n)]


def _jax_atlas(maps, current):
    ja = jatlas.Atlas(*DIMS)
    ja.maps = [jax_map_state(s) for s, _ in maps]
    ja.meta = [jatlas.MapMeta(m.n_kf, m.n_lm, m.kf_parent) for _, m in maps]
    ja.current = current
    return ja


def _assert_atlases_equal(got, want):
    """Two atlases' maps as numpy (the JAX package's dtypes), counters,
    spanning trees and current index, equal."""
    g = convert.atlas_to_numpy(got) if not isinstance(got, dict) else got
    assert tuple(g["dims"]) == tuple(want.dims)
    assert g["current"] == want.current
    assert len(g["maps"]) == len(want.maps)
    for (n_kf, n_lm, par), m in zip(g["meta"], want.meta):
        assert (n_kf, n_lm) == (m.n_kf, m.n_lm)
        if m.kf_parent is None:
            assert par is None
        else:
            np.testing.assert_array_equal(par, m.kf_parent)
    for gs, ws in zip(g["maps"], want.maps):
        for group in ("kfs", "lms", "obs"):
            for name in getattr(ws, group)._fields:
                x = np.asarray(getattr(getattr(ws, group), name))
                y = getattr(getattr(gs, group), name)
                assert y.dtype == x.dtype, (group, name)
                np.testing.assert_array_equal(y, x, err_msg=f"{group}.{name}")


def test_port_round_trip(tmp_path):
    maps = _maps(0)
    want = _jax_atlas(maps, current=2)
    at = convert.atlas_to_torch(want, "cpu")
    tck.save_atlas(str(tmp_path / "ck"), at)
    back = tck.load_atlas(str(tmp_path / "ck"), "cpu")
    _assert_atlases_equal(back, want)
    assert back.device.type == "cpu"


@pytest.mark.parametrize("current", [0, 1])
def test_jax_checkpoint_loads_in_the_port(tmp_path, current):
    want = _jax_atlas(_maps(1), current)
    jck.save_atlas(str(tmp_path / "ck"), want)
    _assert_atlases_equal(tck.load_atlas(str(tmp_path / "ck"), "cpu"), want)


@pytest.mark.parametrize("current", [0, 2])
def test_port_checkpoint_loads_in_jax(tmp_path, current):
    want = _jax_atlas(_maps(2), current)
    tck.save_atlas(str(tmp_path / "ck"), convert.atlas_to_torch(want, "cpu"))
    got = jck.load_atlas(str(tmp_path / "ck"))
    _assert_atlases_equal(dict(
        dims=got.dims, current=got.current,
        maps=[type(s)(*(type(g)(*(np.asarray(a) for a in g)) for g in s))
              for s in got.maps],
        meta=[(m.n_kf, m.n_lm, m.kf_parent) for m in got.meta]), want)
    # The manifest is the JAX package's, field for field.
    jck.save_atlas(str(tmp_path / "jax"), want)
    with open(tmp_path / "ck" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax" / "manifest.json") as f:
        theirs = json.load(f)
    for m in mine["maps"] + theirs["maps"]:
        m.pop("sha256")
    assert mine == theirs


def test_corruption_is_detected(tmp_path):
    at = convert.atlas_to_torch(_jax_atlas(_maps(3, n=2), 0), "cpu")
    path = tmp_path / "ck"
    tck.save_atlas(str(path), at)
    raw = bytearray((path / "map_1.npz").read_bytes())
    raw[len(raw) // 2] ^= 0x40
    (path / "map_1.npz").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        tck.load_atlas(str(path), "cpu")
    # The JAX loader refuses the same file.
    with pytest.raises(IOError, match="checksum mismatch"):
        jck.load_atlas(str(path))
    tck.save_atlas(str(path), at)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["version"] = 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="unsupported atlas format"):
        tck.load_atlas(str(path), "cpu")


def _systems():
    jv = jbow.load_vocabulary(str(graft.RELOC_VOCABULARY))
    tv = tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu")
    max_kf, max_lm, max_obs, nf = DIMS
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
              n_features=nf, max_kf=max_kf, max_lm=max_lm, max_obs=max_obs,
              fps=10)
    return (jsys.MonoSlam(jsys.SlamConfig(**kw, vocabulary=jv,
                                          device_mesh=False)),
            tsys.MonoSlam(tsys.SlamConfig(**kw, vocabulary=tv),
                          device="cpu"))


def test_load_atlas_checkpoint_rebuilds_the_databases(tmp_path):
    """A JAX system's checkpoint loaded into a JAX and a port system: each
    loaded map's database (words, liveness exact; vectors within 1e-6), a
    fresh active map after them with an empty database, the state machine
    reset."""
    want = _jax_atlas(_maps(4), current=1)
    js, ts = _systems()
    js.atlas = want
    path = str(tmp_path / "ck")
    js.save_atlas_checkpoint(path)
    js2, ts2 = _systems()
    js2.load_atlas_checkpoint(path)
    ts2.load_atlas_checkpoint(path)
    assert len(ts2.atlas.maps) == len(js2.atlas.maps) == 4
    assert ts2.atlas.current == js2.atlas.current == 3
    assert ts2.status == js2.status == tsys.NOT_INITIALIZED
    assert ts2.last_kf_id == js2.last_kf_id == -1
    lj, lt = js2.loop_closer, ts2.loop_closer
    assert sorted(lt.dbs) == sorted(lj.dbs) == [0, 1, 2, 3]
    assert lt.active == lj.active == 3
    for idx in lj.dbs:
        vt, wt, okt = convert.keyframe_db_to_numpy(lt.dbs[idx])
        np.testing.assert_array_equal(okt, np.asarray(lj.dbs[idx].valid))
        np.testing.assert_array_equal(wt, np.asarray(lj.dbs[idx].words))
        np.testing.assert_allclose(vt, np.asarray(lj.dbs[idx].vecs),
                                   atol=1e-6)
    assert not np.asarray(lj.dbs[3].valid).any()
    got = convert.atlas_to_numpy(ts2.atlas)
    _assert_atlases_equal(dict(got, maps=got["maps"][:3],
                               meta=got["meta"][:3], current=1), want)


def test_port_system_checkpoint_loads_in_jax(tmp_path):
    """The port system's ``save_atlas_checkpoint`` reads back in the JAX
    system."""
    want = _jax_atlas(_maps(5, n=2), current=0)
    js, ts = _systems()
    ts.atlas = convert.atlas_to_torch(want, "cpu")
    path = str(tmp_path / "ck")
    ts.save_atlas_checkpoint(path)
    assert sorted(os.listdir(path)) == ["manifest.json", "map_0.npz",
                                        "map_1.npz"]
    js.load_atlas_checkpoint(path)
    assert len(js.atlas.maps) == 3 and js.atlas.current == 2
    got = jck.load_atlas(path)
    for gs, ws in zip(got.maps, want.maps):
        for a, b in zip(gs.kfs.kp_desc, ws.kfs.kp_desc):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_capacity_mismatch_is_refused(tmp_path):
    want = _jax_atlas(_maps(6, n=1), current=0)
    path = str(tmp_path / "ck")
    jck.save_atlas(path, want)
    tv = tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu")
    ts = tsys.MonoSlam(tsys.SlamConfig(
        fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=64, max_kf=32, max_lm=256, max_obs=4, vocabulary=tv),
        device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        ts.load_atlas_checkpoint(path)
