"""Build the native shared libraries (libhv.so) into build/native/ at the
root of the checkout.

Usage: python -m cmoop_audio_processing_torch.native.build [--force]
Idempotent: skips compilation when the .so is newer than its source. The
library is written under a temporary name and renamed into place, so a
reader never loads a half-written file.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(NATIVE_DIR)),
                         "build", "native")
HV_LIB = os.path.join(BUILD_DIR, "libhv.so")

TARGETS = [
    ("hv.cpp", "libhv.so"),
]


def build(force: bool = False, out_dir: str = BUILD_DIR) -> bool:
    """Compile all native targets into ``out_dir``; returns True if
    everything is available."""
    ok = True
    os.makedirs(out_dir, exist_ok=True)
    for src_name, out_name in TARGETS:
        src = os.path.join(NATIVE_DIR, src_name)
        out = os.path.join(out_dir, out_name)
        if (
            not force
            and os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)
        ):
            continue
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
        os.close(fd)
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            os.unlink(tmp)
            print(f"native build failed for {src_name}: {e}", file=sys.stderr)
            ok = False
    return ok


if __name__ == "__main__":
    sys.exit(0 if build(force="--force" in sys.argv) else 1)
