"""Loader for the native frame-pipe reader (top-level native/framefeed.c).

Compiles the C extension on first use (gcc is in the image; no pybind11 —
plain CPython C API) and caches the shared object next to the source.
Falls back cleanly to ``None`` so the pure-Python pipe reader keeps working
everywhere.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SRC = _NATIVE_DIR / "framefeed.c"
_SO = _NATIVE_DIR / "framefeed.so"

_module = None
_tried = False


def _build() -> bool:
    include = sysconfig.get_paths()["include"]
    cmd = [
        "gcc", "-O2", "-shared", "-fPIC", "-pthread",
        f"-I{include}", str(_SRC), "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def load() -> Optional[object]:
    """Return the framefeed module, building it if necessary."""
    global _module, _tried
    if _module is not None or _tried:
        return _module
    _tried = True
    if not _SRC.exists():
        return None
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        spec = importlib.util.spec_from_file_location("framefeed", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    except Exception:
        _module = None
    return _module
