#!/usr/bin/env python3
"""Record the JAX side of ``tests/test_torch_chessboard_system.py``'s
lockstep run (and the stages its system timed, which
``tests/test_torch_timers.py`` reads).

    JAX_PLATFORMS=cpu python scripts/chessboard_parity_jax.py

Runs the JAX package's ``MonoSlam`` and the port's in lockstep on the first
9 committed chessboard frames at 640x512 (``tests/chessboard_parity.py``,
``record``), writes the JAX side to
``tests/golden/chessboard_parity_jax.pkl.xz``, then replays the port's side
from the file alone (``replay``, as the tests do) and checks that it is the
lockstep run's port side, pose for pose. Prints one JSON line: the snoop
and rebase frames, the stages, the file's bytes. Rerun it when the port's
or the JAX package's behaviour on those frames changes. About 2 minutes on
the CPU.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    import torch
    torch.set_num_threads(4)
    import chessboard_parity as cp

    t0 = time.perf_counter()
    saved, records, events = cp.record()
    cp.save(saved)
    cp.load.cache_clear()
    cp.replay.cache_clear()
    again, ev = cp.replay()
    for a, b in zip(records, again):
        pa, pb = a["port"]["pose"], b["port"]["pose"]
        assert (pa is None) == (pb is None)
        if pa is not None:
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)
        assert a["port"]["n_lm"] == b["port"]["n_lm"]
    assert ev["rebase"] == events["rebase"]
    print(json.dumps(dict(snoop=events["snoop"], rebase=events["rebase"],
                          stages=saved["stages"],
                          stage_counts=saved["stage_counts"],
                          bytes=os.path.getsize(cp.FIXTURE),
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
