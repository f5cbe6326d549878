"""Time the build of the port's image decoder library two ways on this
host, in one run: one g++ call that compiles the sources one after another
(as utils/native.py built it before), and utils/native.py's `_compile`,
which compiles each source to an object of its own, all at once, then
links. Both use native.IMAGE_CXXFLAGS and write into a temporary directory,
so the library the port loads is left alone.

    python tools/image_build_time.py

Prints the card's name and power limit first where nvidia-smi answers.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tracy_tpu_torch.utils import native  # noqa: E402


def main():
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()
        print(out[0] if out else "nvidia-smi: no card")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    sources = list(native.IMAGE_SOURCES)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run([cxx, *native.IMAGE_CXXFLAGS, "-o", os.path.join(tmp, "serial.so"),
                              *sources], capture_output=True, text=True)
        serial = time.perf_counter() - t0
        if res.returncode:
            raise SystemExit(res.stderr[-2000:])
        t0 = time.perf_counter()
        err = native._compile(os.path.join(tmp, "parallel", "libtracy_image.so"), sources,
                              native.IMAGE_CXXFLAGS)
        parallel = time.perf_counter() - t0
        if err:
            raise SystemExit(err)
    print(f"image library, {len(sources)} sources, {os.cpu_count()} CPUs: one g++ call "
          f"{serial:.2f} s; one object per source in parallel, then a link {parallel:.2f} s")


if __name__ == "__main__":
    main()
