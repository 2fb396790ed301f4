"""Leveled logging (Verbose::PrintMess parity,
ORB-SLAM3 include/System.h:47-72: QUIET/NORMAL/VERBOSE/V_DEBUG/ALL
over stdout, default NORMAL)."""

from __future__ import annotations

QUIET = 0
NORMAL = 1
VERBOSE = 2
DEBUG = 3
ALL = 4

_level = NORMAL


def set_level(level: int):
    global _level
    _level = level


def get_level() -> int:
    return _level


def print_mess(msg: str, level: int = NORMAL):
    if level <= _level:
        print(msg, flush=True)
