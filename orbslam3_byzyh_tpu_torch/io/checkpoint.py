"""Atlas checkpoints: save and load every map of an atlas.

Port of the JAX package's ``io/checkpoint.py`` (ORB-SLAM3's
``System::SaveAtlas`` / ``LoadAtlas`` with their MD5 sidecar), in the same
on-disk format, so that a checkpoint written by either package loads in the
other: a directory with one ``map_<i>.npz`` per map (the state's fields as
``kfs.*``, ``lms.*``, ``obs.*``, the spanning tree as ``meta.kf_parent``
when the map has one) and a ``manifest.json`` (format version, current map,
capacities, each map's file, counters and SHA-256). Descriptors are written
as the JAX package's uint32 words: the port's int32 words viewed, never
converted by value.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .. import device as device_mod
from ..models import atlas as atlas_mod
from ..models import map_state as ms

FORMAT_VERSION = 2
_DESC = ("kp_desc", "desc")


def _flatten_state(state: ms.MapState) -> dict:
    """The map's fields as numpy under their ``group.field`` keys, in one
    read from the device; descriptors as uint32 words."""
    keys, xs = [], []
    for group in ("kfs", "lms", "obs"):
        nt = getattr(state, group)
        for field, x in zip(nt._fields, nt):
            keys.append((group, field, x.dtype))
            xs.append(x)
    host = torch.cat([x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool
                      else x.reshape(-1).to(torch.uint8) for x in xs]).cpu()
    out, i = {}, 0
    for (group, field, dtype), x in zip(keys, xs):
        n = x.numel() * x.element_size()
        raw = host[i:i + n].numpy()
        a = (raw.astype(bool) if dtype == torch.bool
             else raw.view(torch.empty(0, dtype=dtype).numpy().dtype))
        a = a.reshape(tuple(x.shape))
        if field in _DESC:
            a = a.view(np.uint32)
        out[f"{group}.{field}"] = a
        i += n
    return out


def _unflatten_state(d, device: torch.device) -> ms.MapState:
    def to_dev(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return device_mod.upload(a, device)

    def build(cls, group):
        return cls(**{f: to_dev(d[f"{group}.{f}"]) for f in cls._fields})

    return ms.MapState(kfs=build(ms.KeyFrames, "kfs"),
                       lms=build(ms.Landmarks, "lms"),
                       obs=build(ms.Observations, "obs"))


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_atlas(path: str, atlas: atlas_mod.Atlas):
    """Write ``atlas`` to the directory ``path`` (made if missing): each
    map's npz, then the manifest with their hashes."""
    os.makedirs(path, exist_ok=True)
    manifest = {"version": FORMAT_VERSION, "current": atlas.current,
                "dims": list(atlas.dims), "maps": []}
    for i, (state, meta) in enumerate(zip(atlas.maps, atlas.meta)):
        fname = f"map_{i}.npz"
        fpath = os.path.join(path, fname)
        extra = {}
        if meta.kf_parent is not None:
            extra["meta.kf_parent"] = np.asarray(meta.kf_parent)
        np.savez_compressed(fpath, **_flatten_state(state), **extra)
        manifest["maps"].append({"file": fname, "n_kf": meta.n_kf,
                                 "n_lm": meta.n_lm,
                                 "sha256": _digest(fpath)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_atlas(path: str, device=None) -> atlas_mod.Atlas:
    """Load the checkpoint directory ``path`` onto ``device`` (``None``:
    the card; raises without one), checking each map's SHA-256 (``IOError``
    on a mismatch) and the format version (``ValueError``)."""
    dev = device_mod.resolve(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported atlas format {manifest['version']}")
    atlas = atlas_mod.Atlas(*manifest["dims"], device=dev)
    atlas.maps, atlas.meta = [], []
    for entry in manifest["maps"]:
        fpath = os.path.join(path, entry["file"])
        if _digest(fpath) != entry["sha256"]:
            raise IOError(f"checksum mismatch for {fpath} "
                          "(corrupted checkpoint)")
        with np.load(fpath) as z:
            atlas.maps.append(_unflatten_state(z, dev))
            parent = (np.asarray(z["meta.kf_parent"], np.int32)
                      if "meta.kf_parent" in z.files else None)
        atlas.meta.append(atlas_mod.MapMeta(n_kf=entry["n_kf"],
                                            n_lm=entry["n_lm"],
                                            kf_parent=parent))
    atlas.current = manifest["current"]
    return atlas
