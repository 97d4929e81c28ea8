"""Tagged colored console logging (reference: utils/slam_utils.py:422-450)."""

from __future__ import annotations

import sys


class Channel:
    PGO = ("\033[36m", "[PoseGraphOpt]")
    LOOP_CLOSURE = ("\033[34m", "[LoopClosure]")
    EDGE_REJECT = ("\033[33m", "[EdgeReject]")
    INFO = ("\033[32m", "[INFO]")
    WARNING = ("\033[31m", "[WARNING]")
    EVAL = ("\033[35m", "[EVAL]")


_RESET = "\033[0m"
_COLOR = sys.stdout.isatty()


def log(msg: str, channel=Channel.INFO, end: str = "\n"):
    color, tag = channel
    if _COLOR:
        print(f"{color}{tag}{_RESET} {msg}", end=end, flush=True)
    else:
        print(f"{tag} {msg}", end=end, flush=True)
