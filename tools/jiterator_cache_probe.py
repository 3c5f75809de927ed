#!/usr/bin/env python3
"""What a CUDA op of torch's jiterator does when its on-disk kernel cache
holds a file that is empty or cut short, on one GPU.

    python3 tools/jiterator_cache_probe.py

torch compiles a jiterator op (torch.exp2 among them) with NVRTC at its
first call in a process and keeps the cubin in a cache directory
(PYTORCH_KERNEL_CACHE_PATH, by default under $HOME) that later processes
load instead of compiling.  The probe points the cache at a fresh
directory under build/, calls torch.exp2 in a child process (which writes
the file), again (which loads it), then with the file cut to 0 bytes, to
100 bytes and to half its length, each child given CHILD_TIMEOUT_S, and
with USE_PYTORCH_KERNEL_CACHE=0 beside the empty file.  It prints what
each child did, and whether libtorch_cuda holds the strings of the
temporary file its cache writes go through."""
from __future__ import annotations

import glob
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 60
CHILD = r'''
import torch
x = torch.randn(3, 4, 2, 40, 64, device="cuda")
try:
    torch.exp2(x)
    torch.cuda.synchronize()
    print("ok")
except Exception as e:
    print("raised", type(e).__name__, str(e)[:200])
'''


def run(env: dict) -> str:
    try:
        r = subprocess.run([sys.executable, "-c", CHILD], env=env,
                           capture_output=True, text=True,
                           timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return f"no answer in {CHILD_TIMEOUT_S} s (killed)"
    return r.stdout.strip() or r.stderr.strip()[-300:]


def library_strings() -> list:
    import torch
    hits = []
    for so in glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib",
                                     "libtorch_cuda.so")):
        data = Path(so).read_bytes()
        for key in (b"_tmp_", b"kernel cache file"):
            i = data.find(key)
            if i >= 0:
                a = data.rfind(b"\0", 0, i) + 1
                hits.append(data[a:data.find(b"\0", i)][:120].decode(
                    "latin-1"))
    return hits


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    print("torch", torch.__version__, torch.cuda.get_device_name(0))
    print("libtorch_cuda strings:", library_strings())
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(dir=ROOT / "build")
    env = dict(os.environ, PYTORCH_KERNEL_CACHE_PATH=d)
    env.pop("USE_PYTORCH_KERNEL_CACHE", None)
    print("first call (compiles):", run(env))
    files = sorted(Path(d).iterdir())
    data = {f: f.read_bytes() for f in files}
    for f, b in data.items():
        print("cache file", f.name, len(b), "bytes")
    print("second call (loads):", run(env))
    for cut in ("0", "100", "half"):
        for f, b in data.items():
            f.write_bytes(b[:len(b) // 2 if cut == "half" else int(cut)])
        print(f"file cut to {cut} bytes:", run(env))
        if cut == "0":
            print("  the same with USE_PYTORCH_KERNEL_CACHE=0:",
                  run(dict(env, USE_PYTORCH_KERNEL_CACHE="0")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
