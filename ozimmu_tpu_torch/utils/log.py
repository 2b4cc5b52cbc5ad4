"""Env-gated stdout logging (reference src/utils.hpp:98-115).

``OZIMMU_INFO`` enables "[ozIMMU LOG]" lines (off by default);
``OZIMMU_ERROR`` enables "[ozIMMU ERROR]" lines (on by default).
"""

from __future__ import annotations

import sys

from .env import env_flag


def log(msg: str) -> None:
    if env_flag("OZIMMU_INFO", default=False):
        print(f"[ozIMMU LOG] {msg}", flush=True)


def error(msg: str) -> None:
    if env_flag("OZIMMU_ERROR", default=True):
        print(f"[ozIMMU ERROR] {msg}", file=sys.stdout, flush=True)
