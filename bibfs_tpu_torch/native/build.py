"""Build-at-first-use for the native C++ host runtime.

``bibfs_native.cpp`` is a byte-for-byte copy of the JAX package's
``bibfs_tpu/native/bibfs_native.cpp``; this package compiles its own
copy with ``g++`` into ``native/build/libbibfs_native.so`` (ignored by
git) the first time a host solve needs it, and rebuilds when the source
is newer than the library. The compile goes to a temporary path and is
moved into place with ``os.replace``, so concurrent builders never leave
a torn library for another process to load. Nothing builds at import.
"""

from __future__ import annotations

import os
import shlex
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "bibfs_native.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
SO = os.path.join(BUILD_DIR, "libbibfs_native.so")


def ensure_built(force: bool = False) -> str:
    """Compile the library when it is missing or older than the source;
    returns its path. A missing compiler or a failed compile raises
    ``OSError``."""
    if (
        not force
        and os.path.exists(SO)
        and os.path.getmtime(SO) >= os.path.getmtime(SRC)
    ):
        return SO
    cxx = os.environ.get("CXX", "g++")
    cxxflags = shlex.split(
        os.environ.get("CXXFLAGS", "-std=c++17 -O3 -fPIC -Wall -Wextra -pthread")
    )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.tmp.{os.getpid()}"
    cmd = [cxx, *cxxflags, "-shared", "-o", tmp, SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, SO)
    except FileNotFoundError as e:
        raise OSError(f"no C++ compiler ({cxx}): {e}") from e
    except subprocess.CalledProcessError as e:
        raise OSError(f"native build failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return SO


if __name__ == "__main__":
    print(ensure_built(force=True))
