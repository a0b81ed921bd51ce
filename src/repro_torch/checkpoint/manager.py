"""Checkpointing: atomic, async-capable, single-process; the JAX package's
on-disk format, so each package restores the other's checkpoints.

Format: one directory `step_XXXXXXXXX/` per step containing
  - arrays.npz       every leaf of the state tree as `leaf_i`, in the order
                     of `jax.tree_util.tree_flatten` (each dict level's keys
                     sorted; see `tree_flatten`)
  - meta.msgpack     {step, treedef (the JAX package's PyTreeDef string),
                     extra (a JSON string)}
  - extra_arrays.npz optional named numpy arrays outside the tree (the SPION
                     SparsityPlan tables); restore returns them under
                     extra["_arrays"]
  - DONE             commit marker (the atomic rename makes the step visible)

Leaves are torch tensors or numpy arrays. bf16 tensors are written as their
2-byte patterns (numpy has no bfloat16; the JAX package's bf16 leaves load
as the same `|V2` void type) and come back as bf16 when the target leaf is
bf16. An async save copies every leaf to the host first, so a step that
updates the parameters in place cannot tear the checkpoint being written;
a failed background write surfaces at the next save()/wait().

Multi-process checkpoints (process 0 writes, every process reads, a commit
barrier) wait in ROADMAP.md item A12.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite

_BF16_FILE = np.dtype("V2")      # bf16 leaves on disk: raw 2-byte patterns


def tree_flatten(tree, _path=()):
    """[(path, leaf)] of a nested dict in `jax.tree_util.tree_flatten`'s
    order: each level's keys sorted, so the order follows the key *tuples*
    (a dotted-name sort differs where a key holds a character below '.').
    None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], _path + (k,))
        return out
    return [(_path, tree)]


def treedef_str(tree) -> str:
    """The string `str(jax.tree_util.tree_structure(tree))` gives for a
    nested dict: the reference writes it into meta.msgpack."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"


def tree_unflatten(target, leaves):
    """`target`'s nested dicts with `leaves` (in tree_flatten order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(target)


def to_host(x) -> np.ndarray:
    """A leaf as a numpy array that nothing else holds: tensors are copied
    off their device (on the CPU `.numpy()` would alias the parameter the
    next step updates in place); bf16 becomes its 2-byte patterns."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_FILE)
        return x.numpy()
    return np.array(x, copy=True)


def _from_file(a: np.ndarray, ref, where: str):
    """Array `a` from a checkpoint as a leaf like `ref` (a tensor: same
    dtype and device; a numpy array: same dtype). Raises on any dtype or
    shape mismatch but the bf16 patterns, which become bf16."""
    shape = tuple(ref.shape)
    if a.shape != shape:
        raise ValueError(f"checkpoint leaf {where} has shape {a.shape}, the "
                         f"target {shape}")
    if isinstance(ref, torch.Tensor):
        if ref.dtype == torch.bfloat16 and a.dtype == _BF16_FILE:
            t = torch.from_numpy(np.array(a, order="C").view(np.int16)
                                 ).view(torch.bfloat16)
        elif a.dtype.kind != "V" and \
                torch.from_numpy(np.empty(0, a.dtype)).dtype == ref.dtype:
            t = torch.from_numpy(np.array(a, order="C"))
        else:
            raise ValueError(f"checkpoint leaf {where} has dtype {a.dtype}, "
                             f"the target {ref.dtype}")
        return t.to(ref.device)
    if np.asarray(ref).dtype != a.dtype:
        raise ValueError(f"checkpoint leaf {where} has dtype {a.dtype}, the "
                         f"target {np.asarray(ref).dtype}")
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 multiprocess: Optional[bool] = None):
        if multiprocess:
            raise NotImplementedError(
                "multi-process checkpoints (process 0 writes, a commit "
                "barrier) are not ported yet; they wait in ROADMAP.md item "
                "A12")
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pins: set = set()
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             extra_arrays: Optional[dict] = None):
        """Copy to the host, then (a)synchronously serialise and commit.
        `extra_arrays` ({name: array}) are written beside the tree (the
        SPION plan tables)."""
        self.wait()  # join and surface any previous async write
        host = [(p, to_host(x)) for p, x in tree_flatten(tree)]
        treedef = treedef_str(tree)
        if extra_arrays is not None:
            extra_arrays = {k: to_host(v) for k, v in extra_arrays.items()}
        args = (step, host, treedef, extra or {}, extra_arrays)
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=args, daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 - surfaced on next save/wait
            self._error = e

    def _write(self, step: int, host, treedef: str, extra: dict,
               extra_arrays: Optional[dict] = None):
        self._reap_orphans(keep_step=step)
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, (_, a) in enumerate(host)})
        if extra_arrays:
            np.savez(os.path.join(tmp, "extra_arrays.npz"), **extra_arrays)
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(msgpack_lite.packb({"step": step, "treedef": treedef,
                                        "extra": json.dumps(extra)}))
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _reap_orphans(self, keep_step: Optional[int] = None):
        """Remove `.tmp_step_*` debris a crash mid-save left behind (without
        DONE and the rename it is invisible to all_steps, and would leak a
        checkpoint of disk per crash). Pinned steps are exempt, as in _gc."""
        keep = None if keep_step is None else f".tmp_step_{keep_step:09d}"
        for name in os.listdir(self.dir):
            if name.startswith(".tmp_step_") and name != keep:
                try:
                    if int(name.split("_")[-1]) in self._pins:
                        continue
                except ValueError:
                    pass
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def wait(self):
        """Block until any in-flight async save is committed; raise if the
        background write failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint background write failed") from err

    def _gc(self):
        steps = self.all_steps(_wait=False)
        for s in steps[: -self.keep] if self.keep else []:
            if s in self._pins:
                continue  # a rollback target outlives the keep window
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- divergence rollback support ---------------------------------------

    def pin(self, step: int):
        """Exempt `step` from _gc and _reap_orphans until unpinned: the
        divergence sentinel pins the last good checkpoint so the rollback
        target cannot age out of the keep window. Pins live in memory (each
        incarnation re-pins the step it restores) and are read from the
        writer thread; set mutation under the GIL is safe there."""
        self._pins.add(int(step))

    def unpin(self, step: int):
        self._pins.discard(int(step))

    def pinned(self):
        return sorted(self._pins)

    def quarantine_after(self, step: int):
        """Move every committed checkpoint with step > `step` aside
        (step_X -> quarantined_step_X): saves after a divergence point hold
        poisoned state and must never be restored. The renamed directories
        keep their payload for forensics but are invisible to all_steps."""
        self.wait()
        for s in self.all_steps(_wait=False):
            if s <= step:
                continue
            src = os.path.join(self.dir, f"step_{s:09d}")
            dst = os.path.join(self.dir, f"quarantined_step_{s:09d}")
            if os.path.exists(dst):
                shutil.rmtree(dst)
            os.rename(src, dst)

    # -- restore -----------------------------------------------------------

    def all_steps(self, _wait: bool = True):
        if _wait:
            self.wait()
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and \
                    os.path.exists(os.path.join(self.dir, name, "DONE")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, target: Any = None):
        """Returns (tree, step, extra). `target` (nested dicts of tensors or
        numpy arrays) gives the structure and each leaf's dtype, shape and
        device; the tree comes back with tensors where the target holds
        tensors. Arrays saved via `extra_arrays` come back under
        extra["_arrays"] ({name: np.ndarray})."""
        self.wait()  # an in-flight async save may be about to commit `step`
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        if target is None:
            raise ValueError("restore requires a `target` tree for the "
                             "structure")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.msgpack"), "rb") as f:
            meta = msgpack_lite.unpackb(f.read())
        refs = tree_flatten(target)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            if len(data.files) != len(refs):
                raise ValueError(f"checkpoint step {step} holds "
                                 f"{len(data.files)} leaves, the target "
                                 f"{len(refs)}")
            leaves = [_from_file(data[f"leaf_{i}"], ref, "/".join(p))
                      for i, (p, ref) in enumerate(refs)]
        tree = tree_unflatten(target, leaves)
        extra = json.loads(meta["extra"]) if meta.get("extra") else {}
        xa_path = os.path.join(path, "extra_arrays.npz")
        if os.path.exists(xa_path):
            with np.load(xa_path) as xa:
                extra["_arrays"] = {k: xa[k] for k in xa.files}
        return tree, meta["step"], extra
