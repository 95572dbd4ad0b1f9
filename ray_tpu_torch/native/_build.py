"""Build the port's native tier with the host compiler at first use.

The JAX package builds its native sources with ``make`` into its own
directory (``ray_tpu/native/Makefile``). The port keeps its own copies of
those sources in ``src/`` and builds them here, never touching the JAX
package's files or loading its libraries, with the Makefile's flags:

* ``shm_store`` — ``g++ -O2 -fPIC -std=c++17 -Wall src/shm_store.cpp -shared
  -lpthread -lrt`` → ``libtpustore.so`` (the shared-memory object store);
* ``io_pool`` — the same flags on ``src/io_pool.cpp`` → ``libtpuio.so``;
* ``hotpath`` — ``cc -O2 -fPIC -shared -Wall -I<this interpreter's headers>
  src/hotpath.c`` → ``_hotpath.so`` (the C id types and frame codec, a
  CPython extension);
* ``client`` — the C++ flags on ``src/client.cpp`` (with
  ``include/ray_tpu_client.h``) → ``libray_tpu_client.so`` (the native thin
  client, namespace ``ray_tpu_torch``); :func:`program` links a C++ main
  against it into an executable.

Each output goes into ``build/<name>-<hash>/`` next to this file
(``.gitignore`` lists ``build/``); the hash covers the source, the compiler
command and, for the extension, the interpreter's version and headers, so
an unchanged tree never rebuilds and a changed source never loads a stale
library. Worker processes and test workers import the tier at the same
time: a build runs under an exclusive file lock, re-checks under it whether
a peer has finished, and compiles to a temporary name that is renamed into
place, so no process can load half a library. ``CC`` and ``CXX`` name other
compilers, as they do for ``make``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
from typing import Dict, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
INCLUDE = os.path.join(_HERE, "include")
BUILD = os.path.join(_HERE, "build")

CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread", "-lrt")

#: name -> (source in src/, output file name, C or C++)
TARGETS: Dict[str, Tuple[str, str, str]] = {
    "shm_store": ("shm_store.cpp", "libtpustore.so", "c++"),
    "io_pool": ("io_pool.cpp", "libtpuio.so", "c++"),
    "hotpath": ("hotpath.c", "_hotpath.so", "c"),
    "client": ("client.cpp", "libray_tpu_client.so", "c++"),
}
#: headers a target's source includes (their bytes are part of its hash)
HEADERS: Dict[str, Tuple[str, ...]] = {"client": ("ray_tpu_client.h",)}


def _command(name: str, out: str) -> List[str]:
    src, _, lang = TARGETS[name]
    path = os.path.join(SRC, src)
    if lang == "c":
        # the headers of the interpreter that will load the extension
        include = sysconfig.get_paths()["include"]
        return [os.environ.get("CC", "cc"), "-O2", "-fPIC", "-shared", "-Wall",
                f"-I{include}", path, "-o", out]
    return [os.environ.get("CXX", "g++"), *CXXFLAGS, path, "-o", out, *LDFLAGS]


def target(name: str) -> Tuple[str, str]:
    """(library path, build directory) of ``name`` for the current source
    and compiler command."""
    src, lib, lang = TARGETS[name]
    h = hashlib.sha256(" ".join(_command(name, lib)).encode())
    if lang == "c":
        h.update(sys.version.encode())
    headers = [os.path.join(INCLUDE, x) for x in HEADERS.get(name, ())]
    for path in [os.path.join(SRC, src)] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD, f"{name}-{h.hexdigest()[:16]}")
    return os.path.join(out_dir, lib), out_dir


def library_path(name: str) -> str:
    """The path of ``name``'s built library, compiling it first when the
    current source has none. Raises ``RuntimeError`` with the compiler's
    output when the build fails, ``OSError`` when there is no compiler."""
    lib, out_dir = target(name)
    return _build_locked(lib, out_dir, lambda tmp: _command(name, tmp), f"native {name}")


def program(main_src: str, name: str) -> str:
    """An executable from the C++ ``main_src`` linked against the native
    client library (``include/`` on its include path, the library found
    at run time by its rpath), built once per source and library into
    ``build/``; returns its path."""
    lib = library_path("client")
    h = hashlib.sha256(lib.encode())
    with open(main_src, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD, f"{name}-{h.hexdigest()[:16]}")
    exe = os.path.join(out_dir, name)
    lib_dir = os.path.dirname(lib)

    def command(tmp: str) -> List[str]:
        return [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-Wall", f"-I{INCLUDE}",
                main_src, "-o", tmp, f"-L{lib_dir}", "-lray_tpu_client",
                f"-Wl,-rpath,{lib_dir}"]

    return _build_locked(exe, out_dir, command, f"program {name}")


def _build_locked(out: str, out_dir: str, command, what: str) -> str:
    """Run ``command(tmp)`` to make ``out`` unless it exists, under the
    build directory's lock, renaming the result into place."""
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # a peer built it while this one waited
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(command(tmp), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(f"building {what} failed "
                                   f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
