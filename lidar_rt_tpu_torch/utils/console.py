"""Colored console logging (reference lib/utils/console_utils.py:305-373):
a copy of `lidar_rt_tpu.utils.console` (the port imports nothing of that
package).

The reference vendors a 1000-line EasyVolcap console layer (rich/tqdm
wrappers, colored helpers, timestamped logging) and star-imports it
everywhere.  The framework needs the same observability surface — colored
severity helpers and a timestamped log line — without the dependency
weight: plain ANSI with auto-disable when stdout is not a terminal or
NO_COLOR is set (https://no-color.org/), so piped logs stay clean.
"""

from __future__ import annotations

import os
import sys
import time

_CODES = {
    "red": "31", "green": "32", "yellow": "33", "blue": "34",
    "magenta": "35", "cyan": "36", "bold": "1",
}


def _enabled() -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    out = getattr(sys, "stdout", None)
    return bool(out is not None and hasattr(out, "isatty") and out.isatty())


def _wrap(code: str, s: object) -> str:
    if not _enabled():
        return str(s)
    return f"\x1b[{code}m{s}\x1b[0m"


def red(s: object) -> str:
    return _wrap(_CODES["red"], s)


def green(s: object) -> str:
    return _wrap(_CODES["green"], s)


def yellow(s: object) -> str:
    return _wrap(_CODES["yellow"], s)


def blue(s: object) -> str:
    return _wrap(_CODES["blue"], s)


def magenta(s: object) -> str:
    return _wrap(_CODES["magenta"], s)


def cyan(s: object) -> str:
    return _wrap(_CODES["cyan"], s)


def bold(s: object) -> str:
    return _wrap(_CODES["bold"], s)


def log(*parts: object, level: str = "info") -> None:
    """Timestamped log line; level colors the tag (info/warn/error)."""
    tag = {"info": green("info"), "warn": yellow("warn"),
           "error": red("error")}.get(level, level)
    stamp = blue(time.strftime("%H:%M:%S"))
    print(f"[{stamp}][{tag}]", *parts, flush=True)


def warn(*parts: object) -> None:
    log(*parts, level="warn")


def error(*parts: object) -> None:
    log(*parts, level="error")
