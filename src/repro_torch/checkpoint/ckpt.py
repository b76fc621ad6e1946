"""Atomic, asynchronous, CRC-checked checkpoints (the reference's
``checkpoint/ckpt.py``, DESIGN.md §7).

The on-disk layout is the reference's, so each package reads what the
other wrote::

    <dir>/step_000000123/
        manifest.json       # step; per leaf: shape, dtype, crc32
        shard_<host>.npz    # the leaves, named by their tree paths
    <dir>/LATEST            # atomic pointer (written via rename)

A leaf is named by its path joined with ``/``: a dict key, a list index,
or a :class:`repro_torch.core.serve.Snapshot`'s leaf index (``0`` to
``7``, :meth:`~repro_torch.core.serve.Snapshot.leaves`).  A forest state
gives ``trees/ao_y/mean``, ``err_win/n``, ``rng`` ...; a tree state
``ao_y/m2``, ``n_nodes`` ...

* ``save`` copies every leaf to the host before it returns (the port's
  ``update`` writes the QO tables in place, so a view would tear), then
  writes on a thread into ``.tmp_step_*`` and renames it into place; the
  ``LATEST`` pointer goes through ``.LATEST.tmp`` and a rename; the
  newest ``keep`` steps are kept.
* ``restore`` validates the manifest (per-leaf CRC32, shape and dtype)
  and raises :class:`CheckpointCorruption` on any defect, truncated or
  unreadable files included.  A tensor leaf of the template comes back as
  a tensor of the template leaf's dtype on the template leaf's device (a
  restore never moves state to the CPU on its own) -- a ``meta`` leaf, a
  shape-only template, comes back on the CPU for ``reshard`` to place; a
  numpy leaf comes back as numpy.
* ``restore_latest`` walks the steps newest-first and skips corrupt ones
  (the serving engine's crash recovery).
* Under a ``DeviceMesh`` a DTensor leaf is saved whole (``full_tensor``,
  a collective every rank takes part in; a ``Checkpointer`` built with
  ``write=False`` then writes nothing, so one rank writes) and restored
  into a DTensor template leaf by ``distribute_tensor`` on the template's
  mesh and placements.  A sharded trainer's checkpoint is therefore the
  same file as a one-device one, and crosses to the reference both ways.

A forest state's generator state ``rng`` (a CPU uint8 tensor: 5,056
bytes for a CPU generator, 16 for a CUDA one) is saved as a leaf and
restored onto the CPU, as the template's own ``rng`` lives there.  The
reference has no ``rng`` and the port no ``keys`` (ROADMAP C3, C13): a
reference forest checkpoint reaches the port through a numpy template of
the reference's layout and ``convert.state_from_numpy``; the reference
refuses a port forest checkpoint (no ``keys`` leaf), and a forest written
on the card does not restore into a CPU template (the ``rng`` shapes
differ).  Tree states and snapshots cross both ways.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.serve import Snapshot

__all__ = ["CheckpointCorruption", "Checkpointer", "reshard"]

_SEP = "/"


class CheckpointCorruption(IOError):
    """A checkpoint step failed validation (CRC/schema/shape mismatch,
    missing leaf, truncated or unreadable file).  Subclasses ``IOError``
    so pre-existing ``except IOError`` call sites keep working."""


def _children(node):
    """``[(name, child)]`` of an inner node, or None for a leaf.  Dict keys
    in sorted order, as the reference's pytree flattening takes them."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, Snapshot):
        return [(str(i), c) for i, c in enumerate(node.leaves())]
    return None


def _paths(tree, prefix=()):
    """Yield ``(name, leaf)`` for every leaf of ``tree``."""
    kids = _children(tree)
    if kids is None:
        yield _SEP.join(prefix), tree
        return
    for name, child in kids:
        yield from _paths(child, prefix + (name,))


def _rebuild(template, leaf_fn, prefix=()):
    """``template`` with every leaf replaced by ``leaf_fn(name, leaf)``."""
    kids = _children(template)
    if kids is None:
        return leaf_fn(_SEP.join(prefix), template)
    new = [_rebuild(c, leaf_fn, prefix + (n,)) for n, c in kids]
    if isinstance(template, dict):
        return {k: v for (k, _), v in zip(kids, new)}
    if isinstance(template, Snapshot):
        return template.with_leaves(new)
    return type(template)(new)


def _dtensor(leaf) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _host_copy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it (a DTensor
    whole)."""
    if _dtensor(leaf):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name: _host_copy(leaf) for name, leaf in _paths(tree)}


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    def leaf_fn(key, leaf):
        if key not in flat:
            raise CheckpointCorruption(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        shape = tuple(leaf.shape) if torch.is_tensor(leaf) else np.shape(leaf)
        if arr.shape != shape:
            raise CheckpointCorruption(
                f"checkpoint leaf {key!r} shape {arr.shape} != template "
                f"{shape}")
        if _dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            mesh = leaf.device_mesh
            whole = torch.as_tensor(arr).to(
                device=torch.device(mesh.device_type), dtype=leaf.dtype)
            return distribute_tensor(whole, mesh, leaf.placements,
                                     src_data_rank=None)
        if torch.is_tensor(leaf):
            # a meta leaf is a shape-only template (the reference's
            # ShapeDtypeStruct): it comes back on the host, for reshard
            where = "cpu" if leaf.device.type == "meta" else leaf.device
            return torch.as_tensor(arr).to(device=where, dtype=leaf.dtype)
        return arr.astype(np.asarray(leaf).dtype)
    return _rebuild(template, leaf_fn)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 write: bool = True):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.write = write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot ``tree``: every leaf is copied to the host before this
        returns (so the caller may go on updating its state in place);
        the file IO runs on a worker thread unless ``blocking``.  With
        ``write=False`` the copies are made (DTensors gathered) and
        nothing is written."""
        flat = _flatten(tree)
        if not self.write:
            return
        self.wait()  # one write in flight at a time

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            shard = os.path.join(tmp, f"shard_{self.host_id}.npz")
            np.savez(shard, **flat)
            manifest = {
                "step": step,
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                               "crc32": zlib.crc32(v.tobytes())}
                           for k, v in flat.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            # atomic LATEST pointer
            ptr_tmp = os.path.join(self.dir, ".LATEST.tmp")
            with open(ptr_tmp, "w") as f:
                f.write(f"step_{step:09d}")
            os.rename(ptr_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- read -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def available_steps(self) -> List[int]:
        """All step directories on disk, ascending (completed renames
        only -- a crashed writer's ``.tmp_step_*`` never appears)."""
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def restore(self, step: int, template, verify: bool = True):
        """CRC-checked restore into the structure of ``template``: nested
        dicts, lists and :class:`Snapshot`\\ s whose leaves are tensors
        (restored on each leaf's device in its dtype) or numpy arrays.  A
        Snapshot's ``depth`` and ``single`` come from the template, its
        ``version`` and ``step`` from the file."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            flat = dict(np.load(os.path.join(d, f"shard_{self.host_id}.npz")))
        except Exception as e:
            # truncated npz (BadZipFile), missing files, mangled json, a
            # leaf npy cut short mid-write: all surface as ONE typed error
            raise CheckpointCorruption(
                f"checkpoint step {step} unreadable: {e!r}") from e
        if verify:
            leaves = manifest.get("leaves", {})
            if set(leaves) != set(flat):
                raise CheckpointCorruption(
                    f"checkpoint corruption at step {step}: manifest names "
                    f"{len(leaves)} leaves, shard holds {len(flat)}")
            for k, v in flat.items():
                meta = leaves[k]
                if (list(v.shape) != meta["shape"]
                        or str(v.dtype) != meta["dtype"]):
                    raise CheckpointCorruption(
                        f"checkpoint corruption in leaf {k!r}: saved "
                        f"{v.shape}/{v.dtype} != manifest "
                        f"{meta['shape']}/{meta['dtype']}")
                if meta["crc32"] != zlib.crc32(v.tobytes()):
                    raise CheckpointCorruption(
                        f"checkpoint corruption in leaf {k!r}")
        return _unflatten_into(template, flat)

    def restore_latest(self, template, verify: bool = True,
                       return_step: bool = False):
        """Restore the newest *valid* checkpoint (the crash-recovery
        entry point): the LATEST pointer first, then every completed step
        newest-first, skipping (and logging) corrupt, truncated or
        schema-mismatched ones.  Raises ``FileNotFoundError`` when none is
        valid.  ``return_step=True`` returns ``(tree, step)``."""
        candidates = []
        latest = self.latest_step()
        if latest is not None:
            candidates.append(latest)
        for s in sorted(self.available_steps(), reverse=True):
            if s not in candidates:
                candidates.append(s)
        for step in candidates:
            try:
                tree = self.restore(step, template, verify=verify)
            except CheckpointCorruption as e:
                print(f"checkpoint: skipping step {step}: {e}",
                      file=sys.stderr)
                continue
            return (tree, step) if return_step else tree
        raise FileNotFoundError(f"no valid checkpoint under {self.dir!r}")


def reshard(tree, device_tree):
    """Re-place a restored tree onto the devices of ``device_tree`` (the
    same structure, a ``torch.device`` or device string a leaf): the
    counterpart of the reference's ``jax.device_put`` onto shardings."""
    devices = dict(_paths(device_tree))
    return _rebuild(tree, lambda key, leaf: torch.as_tensor(
        leaf, device=torch.device(devices[key])))
