"""Wrappers of the port's CUDA kernels, and their build.

Seven kernels in six CUDA C++ files under ``repro_torch/csrc/``, each with a
plain C interface and a launcher module here.  K1–K5 are the parser's, K6 and
K7 the LM serving path's:

  ``reach_chunk_product``         K1, ``csrc/reach.cu``            (``reach.py``)
  ``build_merge_packed``          K2, ``csrc/build_merge.cu``      (``build.py``)
  ``semiring_matmul``             K3, ``csrc/semiring.cu``         (``semiring.py``)
  ``packed_reach_chunk_product``  K4, ``csrc/packed_reach.cu``     (``packed_reach.py``)
  ``sparse_reach_rows``           K5, ``csrc/packed_reach.cu``     (``sparse_reach.py``)
  ``flash_attention``             K6, ``csrc/flash_attention.cu``  (``flash_attention.py``)
  ``ssd_chunk``                   K7, ``csrc/ssd_chunk.cu``        (``ssd_chunk.py``)

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library at first use — one ``nvcc`` per source, all started together — under
``repro_torch/kernels/_build/``, named by a hash of the source and flags so
an edited source is rebuilt.  The libraries are loaded with ``ctypes``.

``semiring_matmul`` takes f32 operands holding only 0 and 1 (every caller's
Boolean matrices): its tensor-core kernel rounds them to bf16, exact on
{0, 1} and on no other value, where the plain version multiplies in f32.

Every wrapper has the signature of its plain version in ``kernels/ref.py``:
tensors (K7's S_prev may be None for ``outputs="state"``), then static
keyword arguments (K6's ``causal`` and ``window``, K7's ``outputs``).
Given CPU tensors it runs that plain version; given CUDA tensors it checks
them, launches the kernel on the current stream, raises if the launch
fails, and adds one to its ``launches`` count (K7's also to the count of
its ``outputs`` mode).  A CUDA tensor never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from . import build as _build
from . import flash_attention as _flash
from . import packed_reach as _packed_reach
from . import reach as _reach
from . import semiring as _semiring
from . import sparse_reach as _sparse_reach
from . import ssd_chunk as _ssd
from .checks import check_cuda
from .ref import (
    build_merge_packed_ref,
    flash_attention_ref,
    packed_reach_chunk_product_ref,
    reach_chunk_product_ref,
    semiring_matmul_ref,
    sparse_reach_rows_ref,
    ssd_chunk_ref,
)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills of each kernel, kept in the build log
]
_LAUNCHERS = (_reach, _build, _semiring, _packed_reach, _sparse_reach, _flash, _ssd)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _target(source: str) -> Path:
    text = (CSRC / f"{source}.cu").read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{source}-{digest}.so"


def build_log(source: str) -> str:
    """The compiler's output (with ``ptxas``'s resource lines) of ``source``'s
    current build, or "" when it has not been built here."""
    log = _target(source).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def _signatures() -> Dict[str, dict]:
    """Every source's C functions, merged over the launchers that share it."""
    sigs: Dict[str, dict] = {}
    for m in _LAUNCHERS:
        sigs.setdefault(m.SOURCE, {}).update(m.SIGNATURES)
    return sigs


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (where needed) and load every kernel library; idempotent.

    Raises with the compiler's output if any build fails.
    """
    sources = _signatures()
    with _lock:
        if len(_libs) == len(sources):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [source for source in sources if not _target(source).exists()]
        if todo:
            nvcc = _nvcc()
            procs = []
            for source in todo:
                target = _target(source)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                procs.append((source, proc, tmp, target))
            failures = []
            for source, proc, tmp, target in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{source}.cu:\n{log.decode(errors='replace')}")
                else:
                    target.with_suffix(".log").write_bytes(log)
                    os.replace(tmp, target)
            if failures:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        for source, signatures in sources.items():
            lib = ctypes.CDLL(str(_target(source)))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = argtypes
            _libs[source] = lib
        return _libs


class KernelWrapper:
    """A kernel's public entry: the plain version on the CPU, the kernel on
    the card.  ``launches`` counts the kernel launches it made; where
    ``case`` names a static keyword and its default, ``case_launches``
    counts them by that keyword's value as well."""

    def __init__(self, name: str, plain, launcher, case: Optional[Tuple[str, str]] = None):
        self.name = name
        self.plain = plain
        self._launcher = launcher
        self._case = case
        self.launches = 0
        self.case_launches: Dict[str, int] = {}

    def __call__(self, *tensors: Optional[torch.Tensor], **static):
        given = [t for t in tensors if t is not None]
        if all(t.device.type == "cpu" for t in given):
            return self.plain(*tensors, **static)
        check_cuda(self.name, *given)
        lib = build()[self._launcher.SOURCE]
        with torch.cuda.device(given[0].device):
            out = self._launcher.launch(lib, *tensors, **static)
        self.launches += 1
        if self._case is not None:
            key = static.get(*self._case)
            self.case_launches[key] = self.case_launches.get(key, 0) + 1
        return out


reach_chunk_product = KernelWrapper("reach_chunk_product", reach_chunk_product_ref, _reach)
build_merge_packed = KernelWrapper("build_merge_packed", build_merge_packed_ref, _build)
# K3: operands must hold only 0 and 1 (multiplied in bf16 on the card)
semiring_matmul = KernelWrapper("semiring_matmul", semiring_matmul_ref, _semiring)
packed_reach_chunk_product = KernelWrapper(
    "packed_reach_chunk_product", packed_reach_chunk_product_ref, _packed_reach
)
sparse_reach_rows = KernelWrapper("sparse_reach_rows", sparse_reach_rows_ref, _sparse_reach)
flash_attention = KernelWrapper("flash_attention", flash_attention_ref, _flash)
ssd_chunk = KernelWrapper("ssd_chunk", ssd_chunk_ref, _ssd, case=("outputs", "both"))

KERNELS = (
    reach_chunk_product,
    build_merge_packed,
    semiring_matmul,
    packed_reach_chunk_product,
    sparse_reach_rows,
    flash_attention,
    ssd_chunk,
)


def reset_launches() -> None:
    """Set every kernel's ``launches`` counts to 0."""
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.case_launches = {}


def launch_counts() -> Dict[str, int]:
    """Every kernel's ``launches`` by name, and each case count as
    ``"name/case"`` (K7: ``"ssd_chunk/state"``, ``"ssd_chunk/y"``)."""
    counts = {k.name: k.launches for k in KERNELS}
    for k in KERNELS:
        counts.update({f"{k.name}/{case}": n for case, n in k.case_launches.items()})
    return counts
