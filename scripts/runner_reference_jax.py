#!/usr/bin/env python3
"""The JAX package's stereo-inertial runner on the fabricated flagship
dataset: the reference figure the port's runner is held to on the card.

    JAX_PLATFORMS=cpu python scripts/runner_reference_jax.py [--workdir DIR]

Writes the EuRoC-layout dataset of the runners' flagship cell with the
port's ``graft.write_runner_dataset("euroc_stereo_inertial", ...)`` (cell
(d)'s 40 pairs through ``graft.euroc_raw_rig``: EuRoC's radtan and its
0.8-degree stereo rotation, the 200 Hz IMU), then runs the unedited JAX
runner ``scripts/run_euroc_stereo_inertial.py`` on it as a user would,
with ``--no-vocabulary`` and the map cut to 48 keyframe / 4096 landmark
slots (``--max-kf 48 --max-lm 4096``, as the earlier ``*_reference_jax.py``
cut theirs: the JAX init's one-hot Schur does not fit a workstation at
1024 / 65536), on the CPU, in a subprocess. Reads back its ``f_`` file
and prints one JSON line: ``graft.runner_gates``' measures of it (the
frames, the ATE without scale alignment against the truth; the speed is
not in the file) and the run's seconds. These are ``graft.RUNNER_JAX``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SLOTS = ("--max-kf", "48", "--max-lm", "4096")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.io import trajectory

    work = args.workdir or tempfile.mkdtemp(prefix="runner_ref_")
    d = graft.write_runner_dataset("euroc_stereo_inertial",
                                   os.path.join(work, "dataset"),
                                   name="jax")
    cmd = [sys.executable,
           os.path.join(ROOT, "scripts", "run_euroc_stereo_inertial.py"),
           *d.argv, *SLOTS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return proc.returncode
    stamps, centres, _ = trajectory.load_tum(os.path.join(work,
                                                          d.outputs[0]))
    out = graft.runner_gates(d, stamps * 1e-9, centres)
    out.update(seconds=seconds, slots=" ".join(SLOTS),
               summary=[ln for ln in proc.stdout.splitlines()
                        if ln.startswith("tracked")])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
