"""Wrappers of the port's CUDA kernels, and their build.

Eight kernels in six CUDA C++ files under ``repro_torch/csrc/``, each with a
plain C interface and a launcher module here.  K1–K5 are the parser's, K6 and
K7 the LM serving path's, and ``unpack_columns`` writes the parse's forest
columns on the card (it replaces no TPU kernel):

  ``reach_chunk_product``         K1, ``csrc/reach.cu``            (``reach.py``)
  ``build_merge_packed``          K2, ``csrc/build_merge.cu``      (``build.py``)
  ``semiring_matmul``             K3, ``csrc/semiring.cu``         (``semiring.py``)
  ``packed_reach_chunk_product``  K4, ``csrc/packed_reach.cu``     (``packed_reach.py``)
  ``sparse_reach_rows``           K5, ``csrc/packed_reach.cu``     (``sparse_reach.py``)
  ``flash_attention``             K6, ``csrc/flash_attention.cu``  (``flash_attention.py``)
  ``ssd_chunk``                   K7, ``csrc/ssd_chunk.cu``        (``ssd_chunk.py``)
  ``unpack_columns``                  ``csrc/build_merge.cu``      (``unpack.py``)

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library at first use — one ``nvcc`` per source, all started together — under
``repro_torch/kernels/_build/``, named by a hash of the source and flags so
an edited source is rebuilt.  The libraries are loaded with ``ctypes``.

``semiring_matmul`` takes f32 operands holding only 0 and 1 (every caller's
Boolean matrices): its tensor-core kernel rounds them to bf16, exact on
{0, 1} and on no other value, where the plain version multiplies in f32.

Every wrapper has the signature of its plain version in ``kernels/ref.py``:
tensors (K7's S_prev may be None for ``outputs="state"``), then static
keyword arguments (K6's ``causal``, ``window`` and ``softcap``, K7's
``outputs``, ``unpack_columns``' ``lengths`` and ``ell``).  Given CPU
tensors it runs that plain version; given CUDA
tensors it checks them, launches the kernel on the current stream, raises
if the launch fails, and adds one to its ``launches`` count (K7's also to
the count of its ``outputs`` mode).  A CUDA tensor never falls back to the
plain version.  Given tensors with no storage (meta, or a ``FakeTensor``
that names the card), it launches nothing: it returns empty outputs of the
launcher's ``shapes`` and tells the active recorder (``MODELED``, the
dry-run's ``launch/op_stats.py``) one modeled launch with the launcher's
``cost``; ``launches`` counts real launches only.

K6 and K7 are differentiable: where autograd records (grad mode on and an
input that requires grad), their wrappers go through the
``torch.autograd.Function``s ``FlashAttention`` and ``SSDChunk``, whose
forward is the wrapper's own (the kernel on the card, the plain version on
the CPU, counted alike) and whose backward recomputes the plain version
under ``torch.enable_grad()`` and differentiates it, as the reference's
``_flash_bwd_vjp`` does (``repro/kernels/ops.py``; its SSD is differentiated
as jnp, the same function).  Under ``torch.no_grad()`` nothing is saved and
the launches are the same.

On a mesh of several ranks the model's tensors are DTensors, and a kernel
reached through ctypes must never see one: ``flash_attention_local`` (and
the SSD's ``models/mamba.ssd_local``) call K6 (K7) through
``torch.distributed.tensor.experimental.local_map`` on each rank's own
batch rows and heads, so the kernel, its autograd Function and its launch
count are per rank.  Plain tensors (one rank, the CPU) go through the same
``local_map`` call, which then calls the function on them as they are.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build as _build
from . import flash_attention as _flash
from . import packed_reach as _packed_reach
from . import reach as _reach
from . import semiring as _semiring
from . import sparse_reach as _sparse_reach
from . import ssd_chunk as _ssd
from . import unpack as _unpack
from .checks import check_cuda
from .ref import (
    build_merge_packed_ref,
    flash_attention_ref,
    packed_reach_chunk_product_ref,
    reach_chunk_product_ref,
    semiring_matmul_ref,
    sparse_reach_rows_ref,
    ssd_chunk_ref,
    unpack_columns_ref,
)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills of each kernel, kept in the build log
]
_LAUNCHERS = (_reach, _build, _semiring, _packed_reach, _sparse_reach, _flash, _ssd, _unpack)

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
    counts them by that keyword's value as well.  With a ``grad`` Function
    (K6, K7) a call that autograd records goes through it."""

    def __init__(self, name: str, plain, launcher, case: Optional[Tuple[str, str]] = None,
                 grad=None):
        self.name = name
        self.plain = plain
        self._launcher = launcher
        self._case = case
        self._grad = grad
        self.launches = 0
        self.case_launches: Dict[str, int] = {}

    def __call__(self, *tensors: Optional[torch.Tensor], **static):
        if self._grad is not None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors
        ):
            unknown = set(static) - set(self._grad.STATIC)
            if unknown:
                raise TypeError(f"{self.name}: unexpected keyword arguments {sorted(unknown)}")
            args = [static.get(k, default) for k, default in self._grad.STATIC.items()]
            return self._grad.apply(*tensors, *args)
        return self.run(*tensors, **static)

    def run(self, *tensors: Optional[torch.Tensor], **static):
        """The plain version on CPU tensors, else one counted kernel launch;
        never recorded by autograd as such (the Functions' forward).
        Tensors with no storage go to :meth:`model` first, whatever device
        they name."""
        given = [t for t in tensors if t is not None]
        if any(abstract(t) for t in given):
            return self.model(*tensors, **static)
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

    def model(self, *tensors: Optional[torch.Tensor], **static):
        """A launch on tensors with no storage (``abstract``): under a
        recorder that models the CPU (``MODELED``, device "cpu") the plain
        version on them, its ATen ops; else empty outputs of the launcher's
        ``shapes``, and the recorder, if any, told of one modeled launch
        with the launcher's ``cost``.  No kernel is built or launched, and
        ``launches`` keeps counting the card's real launches only."""
        sink = MODELED[-1] if MODELED else None
        if sink is not None and sink.device == "cpu":
            return self.plain(*tensors, **static)
        like = next(t for t in tensors if t is not None)
        out = _empty_like_spec(like, self._launcher.shapes(*tensors, **static))
        if sink is not None:
            case = None if self._case is None else static.get(*self._case)
            sink.kernel(self.name, case, self._launcher.cost(*tensors, **static))
        return out


#: the active recorders of modeled launches, innermost last
#: (``launch/op_stats.OpRecorder`` enters and leaves it)
MODELED: list = []


def abstract(t: torch.Tensor) -> bool:
    """True for a tensor with no storage to launch on: on the meta device,
    or a ``FakeTensor`` (which names the device it stands for)."""
    return t.device.type == "meta" or isinstance(t, FakeTensor)


def _empty_like_spec(like: torch.Tensor, spec):
    """Empty tensors on ``like``'s device for a ``shapes`` spec: one
    (shape, dtype), or a tuple of them and None."""
    if spec is None:
        return None
    if len(spec) == 2 and isinstance(spec[1], torch.dtype):
        return like.new_empty(spec[0], dtype=spec[1])
    return tuple(_empty_like_spec(like, s) for s in spec)


reach_chunk_product = KernelWrapper("reach_chunk_product", reach_chunk_product_ref, _reach)
build_merge_packed = KernelWrapper("build_merge_packed", build_merge_packed_ref, _build)
# K3: operands must hold only 0 and 1 (multiplied in bf16 on the card)
semiring_matmul = KernelWrapper("semiring_matmul", semiring_matmul_ref, _semiring)
packed_reach_chunk_product = KernelWrapper(
    "packed_reach_chunk_product", packed_reach_chunk_product_ref, _packed_reach
)
sparse_reach_rows = KernelWrapper("sparse_reach_rows", sparse_reach_rows_ref, _sparse_reach)
# a bucket group's (n+1, ℓ) bool forest columns, one tensor a text
unpack_columns = KernelWrapper("unpack_columns", unpack_columns_ref, _unpack)


def _recompute_grads(ctx, plain, static: Dict[str, Any], grads_out: Sequence) -> list:
    """The gradients of ``plain(*saved, **static)`` with respect to the saved
    inputs that need them (None for the others), recomputed under
    ``torch.enable_grad()`` and pulled back from ``grads_out`` (one per
    output; outputs that are None, or whose gradient is None, add nothing)."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(saved, needs)]
        outs = plain(*inputs, **static)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if o is not None and g is not None]
        wrt = [t for t, need in zip(inputs, needs) if need and t is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wrt else ())
    return [next(got, None) if need and t is not None else None for t, need in zip(inputs, needs)]


class FlashAttention(torch.autograd.Function):
    """K6 under autograd: forward through ``flash_attention.run`` (the kernel
    on the card), backward by recomputing ``flash_attention_ref``."""

    STATIC = {"causal": True, "window": None, "softcap": None}

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, softcap=None):
        ctx.static = {"causal": causal, "window": window, "softcap": softcap}
        ctx.save_for_backward(q, k, v)
        return flash_attention.run(q, k, v, **ctx.static)

    @staticmethod
    def backward(ctx, grad_out):
        return (*_recompute_grads(ctx, flash_attention_ref, ctx.static, (grad_out,)),
                None, None, None)


class SSDChunk(torch.autograd.Function):
    """K7 under autograd, in each ``outputs`` mode the SSD asks for
    (``"state"``, ``"y"``; ``"both"`` too): forward through
    ``ssd_chunk.run``, backward by recomputing ``ssd_chunk_ref``.  The output
    not asked for is None and has no gradient."""

    STATIC = {"outputs": "both"}

    @staticmethod
    def forward(ctx, xdt, cs, B, C, S_prev, outputs="both"):
        ctx.static = {"outputs": outputs}
        ctx.save_for_backward(xdt, cs, B, C, S_prev)
        return ssd_chunk.run(xdt, cs, B, C, S_prev, outputs=outputs)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return (*_recompute_grads(ctx, ssd_chunk_ref, ctx.static, (grad_y, grad_state)), None)


flash_attention = KernelWrapper("flash_attention", flash_attention_ref, _flash,
                                grad=FlashAttention)
ssd_chunk = KernelWrapper("ssd_chunk", ssd_chunk_ref, _ssd, case=("outputs", "both"),
                          grad=SSDChunk)

KERNELS = (
    reach_chunk_product,
    build_merge_packed,
    semiring_matmul,
    packed_reach_chunk_product,
    sparse_reach_rows,
    flash_attention,
    ssd_chunk,
    unpack_columns,
)


def local_placements(t, keep: Sequence[int]) -> Optional[list]:
    """``t``'s DTensor placements with every split of a dim outside ``keep``
    (and any partial sum) made whole — the layout a kernel that runs
    independently along the ``keep`` dims takes — or None for a plain
    tensor."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return None
    return [p if p.is_shard() and p.dim in keep else Replicate() for p in t.placements]


def on_local_shards(fn, out_places, in_places, grad_places=None, mesh=None):
    """``fn`` mapped over each rank's local tensors (``local_map``): DTensor
    arguments are laid out by ``in_places`` first (redistributed where they
    differ); outputs become DTensors laid out by ``out_places``; the
    gradients of the local inputs are read as laid out by ``grad_places``
    (default ``in_places``).  With no DTensor argument ``fn`` runs on the
    arguments as they are."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_places, in_placements=in_places,
                     in_grad_placements=grad_places, device_mesh=mesh,
                     redistribute_inputs=True)


def flash_attention_local(q, k, v, **static):
    """K6 on each rank's batch rows (dim 0) and heads (dim 2) of (b, L, h, hd)
    ``q``, ``k``, ``v``: the sequence and head_dim whole, the three laid out
    as q; the output laid out so too.  Attention is independent across rows
    and heads, so each rank's gradients are its own (no reduction)."""
    places = local_placements(q, (0, 2))

    def attend(q_, k_, v_):
        return flash_attention(q_.contiguous(), k_.contiguous(), v_.contiguous(), **static)

    return on_local_shards(attend, places, (places,) * 3)(q, k, v)


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
