"""Fault-tolerant checkpointing: atomic, keep-k — the port of
``repro.train.checkpoint``, on the reference's on-disk layout.

  * a checkpoint is a directory ``step_<n>/`` holding ``arrays.npz`` (the
    flat leaves, ``leaf_0`` …) and ``manifest.json`` (step, leaf count,
    shapes, dtypes, a description of the tree, ``extra``);
  * the leaves are in the reference's flatten order: dict keys sorted,
    tuples and named tuples (``OptState``: step, master, m, v) in field
    order; bf16 leaves are stored as their uint16 bit patterns with dtype
    "bfloat16" in the manifest, as the reference stores them — so a
    checkpoint written by either package restores in the other;
  * writes go to ``step_<n>.tmp/`` and are renamed when complete: a crash
    mid-write never corrupts the latest checkpoint;
  * the ``keep`` newest checkpoints are retained, older ones removed after a
    successful write (never before);
  * ``async_save`` copies the leaves to the host before it returns, then
    writes on a background thread.

On a mesh the leaves are DTensors: ``save`` gathers each whole
(``full_tensor``, a collective every rank makes), so the layout on disk is
the same on any mesh; rank 0 alone writes, and the others wait for it at a
barrier.  ``restore`` loads into the structure of ``like`` and puts each
leaf on the device of ``like``'s leaf, then, where ``shardings`` gives a
leaf a ``NamedSharding`` on a mesh of several ranks, cuts it to this rank's
shard (the stored arrays are whole, so any mesh works: elastic restore,
within one head plan — the padded shapes must match).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree: Any) -> List[Any]:
    """Leaves in the reference's (``jax.tree``) order; None has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(item, leaves) for item in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _describe(tree: Any) -> str:
    """The tree's structure with ``*`` for each leaf (the manifest's
    ``treedef``, for the reader: neither package parses it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _flatten_up_to(like: Any, tree: Any) -> List[Any]:
    """``tree``'s entries at the places of ``like``'s leaves (``tree`` has
    ``like``'s structure down to them; its entries may be None)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _flatten_up_to(like[k], tree[k])]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, tree) for x in _flatten_up_to(a, b)]
    return [tree]


def _spmd(leaves: List[Any]) -> bool:
    """Are the leaves DTensors (a mesh of several ranks)?"""
    return any(hasattr(leaf, "full_tensor") for leaf in leaves)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(storable numpy array, dtype name): bf16 as its uint16 bits.  A
    DTensor is gathered whole first (a collective)."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)     # a copy even on the CPU: the caller may write
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype))


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- paths

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        """Write ``tree`` as checkpoint ``step``.  With DTensor leaves every
        rank must call it: each gathers the leaves, rank 0 writes, and all
        meet at a barrier before returning."""
        self.wait()  # serialize with any in-flight async save
        snapshot = self._snapshot(tree)
        spmd = _spmd(_flatten(tree))
        if not spmd or dist.get_rank() == 0:
            self._write(step, snapshot, extra)
        if spmd:
            dist.barrier()
        return self._step_dir(step)

    def _snapshot(self, tree: Any) -> Tuple[List[Tuple[np.ndarray, str]], str]:
        return [_to_host(leaf) for leaf in _flatten(tree)], _describe(tree)

    def _write(self, step: int, snapshot, extra: Optional[Dict] = None) -> Path:
        leaves, described = snapshot
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{f"leaf_{i}": arr for i, (arr, _) in enumerate(leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": described,
            "shapes": [list(arr.shape) for arr, _ in leaves],
            "dtypes": [dtype for _, dtype in leaves],
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    def async_save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """``save`` on a background thread, after the leaves are copied to the
        host (the caller may update the tensors in place): with DTensor
        leaves every rank gathers them and rank 0 alone writes (no barrier:
        a reader waits for the manifest)."""
        snapshot = self._snapshot(tree)
        self.wait()
        if _spmd(_flatten(tree)) and dist.get_rank() != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, snapshot, extra), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------ restore

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[int, Any, Dict]:
        """Load checkpoint ``step`` (None: the latest) into the structure of
        ``like``; each leaf goes to the device of ``like``'s leaf (a
        non-tensor leaf of ``like`` gets a CPU tensor), and where
        ``shardings`` (``like``'s structure, entries ``NamedSharding`` or
        None) places it on a mesh of several ranks, to this rank's shard."""
        from ..launch.mesh import mesh_chips
        from ..parallel.sharding import place
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        like_leaves = _flatten(like)
        places = _flatten_up_to(like, shardings) if shardings is not None else [None] * len(
            like_leaves)
        if manifest["n_leaves"] != len(like_leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected {len(like_leaves)}"
            )
        leaves = []
        with np.load(d / "arrays.npz") as data:
            for i, want in enumerate(like_leaves):
                stored = _from_host(data[f"leaf_{i}"], manifest["dtypes"][i])
                if tuple(stored.shape) != tuple(want.shape):
                    raise ValueError(
                        f"checkpoint leaf shape {tuple(stored.shape)} != expected "
                        f"{tuple(want.shape)}"
                    )
                if isinstance(want, torch.Tensor):
                    stored = stored.to(want.device)
                sh = places[i]
                if sh is not None and mesh_chips(sh.mesh) > 1:
                    stored = place(stored, sh.mesh, sh.spec)
                leaves.append(stored)
        return step, _unflatten(like, iter(leaves)), manifest.get("extra", {})
