"""Build the hand-written kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel package (``kernels/<pkg>/``) keeps its CUDA sources under
``csrc/`` and owns one :class:`KernelLibraries`. Every ``csrc/<name>.cu``
has a plain C interface and compiles, on first use, into
``build/lib<name>-<hash>.so`` beside the package (the hash covers the
source, the package's shared ``csrc/*.cuh`` headers and its flags, so an
edited source, header or flag rebuilds). Only sources in the repository
are compiled; nothing is fetched. Importing this module builds nothing:
:meth:`KernelLibraries.build`, :meth:`KernelLibraries.load` and
:func:`build_all` do, and only on a machine with the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["KernelLibraries", "build_all", "BASE_FLAGS", "PACKAGES", "PROBE"]

#: sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels;
#: ``-Xptxas -v`` leaves each kernel's registers, shared memory and
#: spills in the library's ``.log``.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600

#: every package's libraries by package name, registered on construction
PACKAGES: Dict[str, "KernelLibraries"] = {}


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the kernels are built from their "
        "csrc/ sources on the machine that runs them"
    )


class KernelLibraries:
    """The CUDA libraries of one kernel package: ``<package>/csrc/*.cu``
    compiled with ``flags`` into ``<package>/build/``."""

    def __init__(self, package_dir: Path, flags: Tuple[str, ...]) -> None:
        package_dir = Path(package_dir).resolve()
        self.name = package_dir.name
        self.csrc = package_dir / "csrc"
        self.build_dir = package_dir / "build"
        self.flags = tuple(flags)
        self._loaded: Dict[str, ctypes.CDLL] = {}
        PACKAGES[self.name] = self

    def names(self) -> list:
        return sorted(p.stem for p in self.csrc.glob("*.cu"))

    def library(self, name: str) -> Path:
        """Where ``csrc/<name>.cu`` builds to under the current flags."""
        digest = hashlib.sha256((self.csrc / f"{name}.cu").read_bytes())
        for header in sorted(self.csrc.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(self.flags).encode())
        return self.build_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"

    def _jobs(self, names: Iterable[str] | None):
        names = self.names() if names is None else list(names)
        return {(self.name, n): (self, n, self.library(n)) for n in names}

    def build(self, names: Iterable[str] | None = None) -> Dict[str, Path]:
        """Compile the named sources (default: every ``csrc/*.cu``) that
        are not built yet, one ``nvcc`` per source, all started together.
        Returns ``{name: library path}``. Raises ``RuntimeError`` with the
        compiler's output if a build fails."""
        return {n: lib for (_, n), lib in _compile(self._jobs(names)).items()}

    def load(self, name: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<name>.cu``, built on first use."""
        if name not in self._loaded:
            self._loaded[name] = ctypes.CDLL(str(self.build([name])[name]))
        return self._loaded[name]


def build_all(*packages: KernelLibraries) -> Dict[Tuple[str, str], Path]:
    """Build every source of the given packages (default: every package
    registered so far), all ``nvcc`` processes started together. Returns
    ``{(package, name): library path}``."""
    jobs = {}
    for pkg in packages or tuple(PACKAGES.values()):
        jobs.update(pkg._jobs(None))
    return _compile(jobs)


#: the empty kernel of ``kernels/csrc/launch_floor.cu``: the cost of a
#: launch on its own, timed beside the kernels by ``chip_smoke.py``
PROBE = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)


def _compile(jobs) -> Dict[Tuple[str, str], Path]:
    libs = {key: lib for key, (_, _, lib) in jobs.items()}
    todo = {key: job for key, job in jobs.items() if not job[2].exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for key, (pkg, name, lib) in todo.items():
        pkg.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *pkg.flags, "-o", str(tmp), str(pkg.csrc / f"{name}.cu")]
        procs[key] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for key, (tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{key}: nvcc timed out\n{out}")
            continue
        lib = todo[key][2]
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"{key}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return libs
