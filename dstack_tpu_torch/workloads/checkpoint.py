"""Async checkpointing in the JAX package's on-disk format.

The port of ``dstack_tpu/workloads/checkpoint.py``. A checkpoint either
package writes, the other reads:

- ``step-%08d/shard-%05d.npz``: one file per process, whose members are
  named ``"<leaf index>@<a:b,c:d>"``, the leaf's position in the flattened
  state and the global index of the piece it holds. Extension dtypes
  (bfloat16, fp8) are stored as same-width unsigned views.
- ``step-%08d/manifest.json``: ``step``, ``process_count``, ``mesh``,
  ``data_offset``, ``leaves`` (key, shape, dtype name) and ``extra``.
- ``step-%08d/_COMMIT-%05d``: written last, once the shard is durable; a
  step is complete when every process's marker exists.

Leaves are keyed by the JAX tree path strings (``jax.tree_util.keystr``):
``leaf_entries`` flattens dicts in sorted key order (``['k']``), named
tuples by field (``.name``) and other tuples and lists by position
(``[i]``), as JAX flattens dicts, optax's states and tuples. The training
state's layout in those terms is ``train.state_tree`` (the MoE branch's is
the reference's ``{"params", "opt"}`` dict).

Meshless, the port writes one whole-array piece per leaf, keyed ``0:n,...``
(``""`` for a 0-d leaf), exactly as a meshless ``jax.Array``'s one
addressable shard is keyed. Under a mesh (``sharding.Mesh``) each rank
writes ``shard-<rank>.npz`` with its local pieces keyed by global index (a
leaf's layout follows its key and the mesh's kind: ``sharding.spec_of_key``
of ``sharding.param_specs``, the serve layout on a serve mesh, the MoE
layout, experts split over ep, on an MoE mesh); a piece that
several ranks hold is written by the first of them only. Rank 0 writes the
manifest (``process_count`` is the world, ``mesh`` its shape) and every rank
its own commit marker. Reading takes from every shard file of a step the
pieces that meet the template's local slice, by global index, so a
checkpoint restores onto any mesh or none, whichever package or mesh wrote
it, one leaf at a time; incomplete coverage raises.

``save()`` blocks only for the device-to-host copy (and the previous
write), writes on a background thread and never raises: a failed save is
counted and marked. A checkpoint that cannot be read raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import telemetry as telemetry_lib
from dstack_tpu_torch.workloads.convert import storage_dtype, tensor_from_host

_STEP_DIR_RE = re.compile(r"^step-(\d+)$")


class LeafSpec(NamedTuple):
    """A template leaf without data (the port's ``jax.ShapeDtypeStruct``):
    restore makes a tensor of this shape and dtype on ``device``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")


def _step_dir(step: int) -> str:
    return f"step-{step:08d}"


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, LeafSpec))


def leaf_entries(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Stable ``(key, leaf)`` pairs in JAX's flattening order, keyed by
    JAX's tree path strings, so both packages name a leaf alike."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_entries(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += leaf_entries(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, child in enumerate(tree):
            out += leaf_entries(child, f"{prefix}[{i}]")
        return out
    raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")


def _rebuild(tree, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator), as ``jax.tree_util.tree_unflatten``."""
    if _is_leaf(tree):
        return next(leaves)
    if isinstance(tree, dict):
        rebuilt = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: rebuilt[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(child, leaves) for child in tree)
    raise TypeError(f"cannot rebuild a {type(tree).__name__}")


def _dtype_name(leaf) -> str:
    """The manifest's dtype name: numpy's (and ml_dtypes') spelling, which
    torch's dtype names share."""
    return str(leaf.dtype).removeprefix("torch.")


def _index_key(index: Tuple[slice, ...]) -> str:
    """The ``a:b,c:d`` key of a piece's global index (``""`` when 0-d)."""
    return ",".join(f"{int(sl.start)}:{int(sl.stop)}" for sl in index)


def _whole(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, int(d)) for d in shape)


def _parse_index(key: str) -> Tuple[slice, ...]:
    if not key:
        return ()
    return tuple(
        slice(int(a), int(b)) for a, b in (p.split(":") for p in key.split(","))
    )


def _host_copy(leaf) -> np.ndarray:
    """Device-to-host copy of one leaf, in its savable form: builtin numpy
    dtypes as they are, extension dtypes as same-width unsigned views. A
    new array, so the training step may go on updating the leaf in place
    while the writer thread holds the copy."""
    if isinstance(leaf, np.ndarray):
        arr = np.array(leaf)
        if arr.dtype.isbuiltin == 1:
            return arr
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    t = leaf.detach().to("cpu", copy=True)
    store = storage_dtype(_dtype_name(t))
    if store is None:
        return t.numpy()
    signed = {1: torch.int8, 2: torch.int16}[t.element_size()]
    return t.view(signed).numpy().view(store)


class CheckpointManager:
    """Async checkpointing of a tree of tensors (the JAX manager's
    contract). ``save()`` is called from the train loop, ``restore()`` at
    startup. One manager per process; under a connected ``mesh`` the
    process is its rank and the tree holds that rank's local pieces."""

    def __init__(
        self,
        directory: str,
        keep: int = 2,
        telemetry: Optional[Any] = None,
        process_index: int = 0,
        process_count: int = 1,
        mesh: Optional[sharding.Mesh] = None,
        whole_keys: Tuple[str, ...] = (),
    ) -> None:
        self.directory = directory
        self.keep = max(1, keep)
        self.mesh = mesh
        self.whole_keys = tuple(whole_keys)
        if mesh is not None:
            process_index, process_count = mesh.rank, mesh.size
        self.process_index = process_index
        self.process_count = process_count
        self._telemetry = telemetry if telemetry is not None else telemetry_lib.get_emitter()
        self.save_errors = 0
        self.last_error: Optional[BaseException] = None
        self.saves = 0
        self._pending: Optional[threading.Event] = None
        self._closed = False
        os.makedirs(directory, exist_ok=True)

    def _place(self, key: str, shape) -> Tuple[Tuple[int, ...], Tuple[slice, ...], bool]:
        """(global shape, global index of this process's piece, whether this
        process writes it) of a leaf of local ``shape``."""
        if self.mesh is None:
            return tuple(int(d) for d in shape), _whole(shape), True
        spec = (() if key.startswith(self.whole_keys) and self.whole_keys
                else sharding.spec_of_key(key, sharding.param_specs(self.mesh)))
        full = sharding.global_shape(spec, shape, self.mesh)
        return (full, sharding.local_slices(spec, full, self.mesh),
                sharding.holds_first_copy(spec, self.mesh))

    # -- writing -----------------------------------------------------------

    def save(
        self,
        step: int,
        state,
        data_offset: Optional[int] = None,
        mesh_shape: Optional[Dict[str, int]] = None,
        extra: Optional[dict] = None,
        block: bool = False,
    ) -> None:
        """Snapshot ``state`` at ``step``. Blocks only for the device-to-host
        copy (and for the previous save's write, if still in flight); the
        write happens on a background thread. Never raises: a failed save is
        counted and marked, not fatal to training."""
        if self._closed:
            return
        t0 = time.perf_counter()
        self._telemetry.mark("checkpoint_start", step=step)
        try:
            # Double-buffer bound: at most one host snapshot awaiting write.
            self.wait()
            payload: Dict[str, np.ndarray] = {}
            leaves: List[dict] = []
            for i, (key, leaf) in enumerate(leaf_entries(state)):
                shape, index, writes = self._place(key, leaf.shape)
                leaves.append({"key": key, "shape": list(shape), "dtype": _dtype_name(leaf)})
                if writes:
                    payload[f"{i}@{_index_key(index)}"] = _host_copy(leaf)
            manifest = {
                "step": int(step),
                "process_count": self.process_count,
                "mesh": dict(mesh_shape) if mesh_shape else None,
                "data_offset": int(data_offset) if data_offset is not None else None,
                "leaves": leaves,
                "extra": extra or {},
            }
        except BaseException as e:  # noqa: BLE001 - never kill the train step
            self.save_errors += 1
            self.last_error = e
            self._telemetry.mark("checkpoint_error", step=step, error=str(e)[:200])
            # Close the bracket: a dangling checkpoint_start would bill the
            # time up to the window's edge to checkpointing in the ledger.
            self._telemetry.mark(
                "checkpoint_end", step=step,
                blocked_s=round(time.perf_counter() - t0, 6), failed=True,
            )
            return
        blocked = time.perf_counter() - t0
        done = threading.Event()
        self._pending = done
        threading.Thread(
            target=self._write, args=(step, payload, manifest, done),
            name="checkpoint-write", daemon=True,
        ).start()
        self._telemetry.mark("checkpoint_end", step=step, blocked_s=round(blocked, 6))
        if block:
            self.wait()

    def _write(self, step: int, payload, manifest, done: threading.Event) -> None:
        t0 = time.perf_counter()
        path = os.path.join(self.directory, _step_dir(step))
        try:
            os.makedirs(path, exist_ok=True)
            shard = os.path.join(path, f"shard-{self.process_index:05d}.npz")
            tmp = shard + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, shard)
            if self.process_index == 0:
                mtmp = os.path.join(path, "manifest.json.tmp")
                with open(mtmp, "w", encoding="utf-8") as f:
                    json.dump(manifest, f)
                os.replace(mtmp, os.path.join(path, "manifest.json"))
            # Commit marker last: readers take the step as complete only when
            # every process's marker exists.
            with open(os.path.join(path, f"_COMMIT-{self.process_index:05d}"), "w") as f:
                f.write(str(step))
            self.saves += 1
            self._telemetry.mark(
                "checkpoint_saved", step=step,
                write_s=round(time.perf_counter() - t0, 6), path=path,
            )
            self._prune()
        except BaseException as e:  # noqa: BLE001
            self.save_errors += 1
            self.last_error = e
            self._telemetry.mark("checkpoint_error", step=step, error=str(e)[:200])
        finally:
            done.set()

    def _prune(self) -> None:
        if self.process_index != 0:
            return
        for step in self.complete_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, _step_dir(step)), ignore_errors=True)

    def wait(self, timeout: float = 600.0) -> bool:
        """Drain the in-flight write (True = nothing pending or it finished)."""
        pending = self._pending
        if pending is None:
            return True
        ok = pending.wait(timeout)
        if ok:
            self._pending = None
        return ok

    def close(self, timeout: float = 600.0) -> None:
        """Drain pending writes; further saves become no-ops. Idempotent."""
        self.wait(timeout)
        self._closed = True

    # -- reading -----------------------------------------------------------

    def complete_steps(self) -> List[int]:
        """Ascending steps whose every per-process commit marker exists."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            manifest = self._read_manifest(path)
            if manifest is None:
                continue
            n = int(manifest.get("process_count") or 1)
            if all(os.path.exists(os.path.join(path, f"_COMMIT-{p:05d}")) for p in range(n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _read_manifest(path: str) -> Optional[dict]:
        try:
            with open(os.path.join(path, "manifest.json"), "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_manifest(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self._read_manifest(os.path.join(self.directory, _step_dir(step)))
        if manifest is None:
            raise FileNotFoundError(f"checkpoint {_step_dir(step)} has no readable manifest")
        return manifest

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint into ``template``'s structure: each leaf comes
        back as a new tensor in the template leaf's dtype and on its device
        (a numpy template leaf gets the host array). Returns ``(tree,
        manifest)``. Raises on any mismatch in structure or shape, and on
        missing shard coverage."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self.read_manifest(step)
        leaves = manifest["leaves"]
        entries = leaf_entries(template)
        if [k for k, _ in entries] != [leaf["key"] for leaf in leaves]:
            raise ValueError(
                f"checkpoint structure mismatch: saved {[leaf['key'] for leaf in leaves]}"
                f" vs template {[k for k, _ in entries]}"
            )
        regions = []
        for (key, leaf), meta in zip(entries, leaves):
            shape, index, _ = self._place(key, leaf.shape)
            if list(shape) != list(meta["shape"]):
                raise ValueError(
                    f"{key}: checkpoint shape {meta['shape']} != template {list(shape)}"
                    f" - the model/optimizer config changed under the checkpoint"
                )
            regions.append(index)
        path = os.path.join(self.directory, _step_dir(step))
        restored = [
            _materialize(leaf, self._load_region(path, leaves, i, regions[i]), leaves[i]["dtype"])
            for i, (_, leaf) in enumerate(entries)
        ]
        return _rebuild(template, iter(restored)), manifest

    def restore_subtree(self, template, step: Optional[int] = None, prefix: str = ""):
        """Restore only the leaves matching ``template``'s keys: the
        train-to-serve handoff (the engine wants ``.params`` of a whole
        TrainState, without reading the optimizer's moments). Each key is
        matched as ``prefix + key`` first, then as a unique suffix; an
        ambiguous suffix raises with the candidate prefixes. Only the
        matched leaves' bytes are read. Returns ``(tree, manifest)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self.read_manifest(step)
        leaves = manifest["leaves"]
        saved_keys = [leaf["key"] for leaf in leaves]
        by_key = {k: i for i, k in enumerate(saved_keys)}
        entries = leaf_entries(template)
        picked: List[int] = []
        regions = []
        for key, leaf in entries:
            i = by_key.get(prefix + key)
            if i is None:
                matches = [j for j, sk in enumerate(saved_keys) if sk.endswith(key)]
                if not matches:
                    raise ValueError(
                        f"checkpoint {_step_dir(step)} has no leaf matching"
                        f" {prefix + key!r} (or suffix {key!r})"
                    )
                if len(matches) > 1:
                    prefixes = sorted(saved_keys[j][: -len(key)] for j in matches)
                    raise ValueError(
                        f"{key!r} is ambiguous in {_step_dir(step)}: matches under prefixes"
                        f" {prefixes} - pass prefix= to pick one"
                    )
                i = matches[0]
            shape, index, _ = self._place(key, leaf.shape)
            if list(shape) != list(leaves[i]["shape"]):
                raise ValueError(
                    f"{key}: checkpoint shape {leaves[i]['shape']} != template"
                    f" {list(shape)} - the model config changed under the checkpoint"
                )
            picked.append(i)
            regions.append(index)
        path = os.path.join(self.directory, _step_dir(step))
        restored = [
            _materialize(leaf, self._load_region(path, leaves, i, region), leaves[i]["dtype"])
            for (_, leaf), i, region in zip(entries, picked, regions)
        ]
        return _rebuild(template, iter(restored)), manifest

    @staticmethod
    def _load_region(path: str, leaves: List[dict], i: int,
                     region: Tuple[slice, ...]) -> np.ndarray:
        """The ``region`` (a global index) of leaf ``i`` as a host array in
        its storage dtype (extension dtypes as unsigned views), from the
        pieces of the step's shard files that meet it; the other pieces'
        bytes are not read. Raises on incomplete coverage."""
        meta = leaves[i]
        store = storage_dtype(meta["dtype"]) or np.dtype(meta["dtype"])
        want = tuple(sl.stop - sl.start for sl in region)
        out = None
        covered = 0
        seen = set()
        shard_files = sorted(
            os.path.join(path, n) for n in os.listdir(path)
            if n.startswith("shard-") and n.endswith(".npz")
        )
        for fname in shard_files:
            with np.load(fname) as z:
                for zkey in z.files:
                    leaf_s, _, idx_key = zkey.partition("@")
                    if int(leaf_s) != i or idx_key in seen:
                        continue  # another leaf, or replicated across processes
                    seen.add(idx_key)
                    index = _parse_index(idx_key)
                    meet = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                                 for a, b in zip(index, region))
                    if any(sl.start >= sl.stop for sl in meet):
                        continue
                    piece = z[zkey]
                    if piece.dtype != store:
                        if piece.dtype.itemsize != store.itemsize:
                            raise ValueError(
                                f"{meta['key']}: shard dtype {piece.dtype}"
                                f" incompatible with manifest {meta['dtype']}"
                            )
                        piece = piece.view(store)
                    if index == region:
                        # The region in one piece (a save on the same layout):
                        # keep the loaded array rather than copy it.
                        out = piece.reshape(want)
                    else:
                        if out is None:
                            out = np.zeros(want, store)
                        out[tuple(slice(m.start - r.start, m.stop - r.start)
                                  for m, r in zip(meet, region))] = piece[
                            tuple(slice(m.start - p.start, m.stop - p.start)
                                  for m, p in zip(meet, index))]
                    covered += int(np.prod([sl.stop - sl.start for sl in meet]))
        need = int(np.prod(want)) if want else 1
        if covered < need:
            raise ValueError(
                f"{meta['key']}: shard files cover {covered}/{need}"
                f" elements - a process's shard file is missing"
            )
        return out


def _materialize(leaf, arr: np.ndarray, dtype_name: str):
    """One restored host array as its template leaf wants it: a tensor in
    the leaf's dtype on its device, or the numpy array for a numpy leaf."""
    if isinstance(leaf, np.ndarray):
        return arr
    t = tensor_from_host(arr, dtype_name)
    return t.to(device=leaf.device, dtype=leaf.dtype)
