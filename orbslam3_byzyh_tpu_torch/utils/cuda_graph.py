"""Fixed-shape device computations replayed as CUDA graphs.

The inertial solvers (``solver/inertial.py``, ``solver/inertial_ba.py``)
are loops of small operations whose Jacobians come from
``torch.func.jacfwd``: tens of thousands of launches a call, each costing
the host far more than the device. They read nothing back to the host, and
their shapes are fixed by the configuration, so on CUDA each is captured
once per shape as a CUDA graph (``torch.cuda.graph``) and replayed: the
inputs are copied into the graph's own tensors, the graph runs, the
outputs are cloned out. The numerics are those of the same operations run
one by one: on CUDA the dense solves are pinned to cuSOLVER both in a
capture and in a run under :func:`disabled` (torch's default choice of
library moves an ill-conditioned solve, the stereo init's accelerometer
bias, by about 3e-4). On the CPU the function simply runs.

A capture costs the host about two runs of the operations one by one
(the warm-up and the capture pass), so the callers pad what varies from
call to call (an IMU window's samples, a keyframe chain) to a few sizes
(:func:`bucket`); the cache holds at most ``MAX_GRAPHS`` graphs, the least
recently used one dropped (with its memory pool) beyond that.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils import _pytree as pytree

MAX_GRAPHS = 32
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
# Graphs captured since the process began (a capture after an eviction
# counts again): what a caller's run captured is the difference.
CAPTURES = [0]
_ENABLED = [True]
# Warm-up runs before a capture (lazy library handles, workspaces, the
# callee's own caches are made outside the graph).
_WARMUP = 1


@contextlib.contextmanager
def disabled():
    """Run the wrapped functions one operation at a time inside the block
    (to hold a replay against them)."""
    _ENABLED.append(False)
    try:
        yield
    finally:
        _ENABLED.pop()


def bucket(n: int, least: int, most: int | None = None) -> int:
    """The size a count ``n`` (<= ``most``) is padded to: the next power
    of two from ``least``, at most ``most``; so a function of padded inputs
    has at most log2(most / least) + 1 graphs."""
    size = max(least, 1 << (n - 1).bit_length())
    return size if most is None else min(most, size)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, str(x.device))
    return ("value", x)


@contextlib.contextmanager
def cusolver():
    """Pin the dense solves to cuSOLVER inside the block (the library a
    capture and :func:`disabled` use)."""
    lib = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(lib)


def _capture(fn, leaves, spec):
    static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    args = pytree.tree_unflatten(static, spec)
    with cusolver():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args)
    return static, graph, out


def call(name: str, fn, *args):
    """``fn(*args)``, replayed as a CUDA graph when the tensors are on a
    CUDA device. ``args`` may nest tuples and NamedTuples of tensors; every
    other leaf (numbers, flags, None) is a constant of the graph: a new
    value, like a new shape, captures a new graph (pass what varies as a
    tensor, pad what varies in size). ``fn`` must not
    synchronise with the host. Returns fresh tensors."""
    leaves, spec = pytree.tree_flatten(args)
    dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
               None)
    if dev is None or dev.type != "cuda":
        return fn(*args)
    if not _ENABLED[-1]:
        with cusolver():
            return fn(*args)
    key = (name, str(spec), tuple(_leaf_key(x) for x in leaves))
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _GRAPHS[key] = _capture(fn, leaves, spec)
        CAPTURES[0] += 1
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)[1][1].reset()
    _GRAPHS.move_to_end(key)
    static, graph, out = entry
    for s, x in zip(static, leaves):
        if isinstance(x, torch.Tensor):
            s.copy_(x)
    graph.replay()
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
