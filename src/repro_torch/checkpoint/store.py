"""Checkpoints and parking-lot spills on disk.

The port of ``repro/checkpoint/store.py``.  Tensors are taken to host
numpy before writing; the file formats are the reference's, so a file
written by either package loads in the other:

  * tree checkpoints (``save``/``restore_flat``/``restore_into``): one
    directory per step holding one ``.npy`` per leaf and a
    ``manifest.json`` of path keys, shapes, dtypes and CRC32s, written to a
    temporary directory and moved into place with ``os.replace``.  Path
    keys are the reference's (``jax.tree_util.keystr``: ``['a'].b[0]``
    for a dict key, a NamedTuple field and a sequence index);
  * session spills (``save_sessions``/``load_sessions``): one ``.npz`` of
    ``/``-joined path keys ("<sid>/blocks/b0/ring1"), a ``__meta__`` JSON
    blob of the service's bookkeeping, and a ``__dtypes__`` sidecar in the
    meta for dtypes numpy cannot name.  Written to ``path + ".tmp"`` and
    moved into place with ``os.replace``.

bfloat16 (the LM KV cache): the port has no ``ml_dtypes``, so on the host a
bf16 leaf is its bits, tagged by the ``|V2`` dtype (``utils/host.py``).
``save_sessions`` writes such a leaf as the reference writes an
``ml_dtypes.bfloat16`` one (``|V2`` bytes) with the ``"bfloat16"`` sidecar
entry, so the reference reads it back as bfloat16; ``load_sessions`` turns
a ``"bfloat16"`` entry of either package's file into the same bits.  A
sidecar naming any other dtype numpy cannot name (fp8) is refused with a
``TypeError``.  ``restore_into`` puts each leaf on the device of the
target's leaf, or, with ``shardings=`` (a tree of launch/specs.NamedSharding
or anything with a ``place(full)`` method), places it on the current mesh:
the files hold whole arrays, so a checkpoint written at one world size
restores at any other.  ``save`` of a tree holding DTensors gathers each
(a collective: every rank of the mesh calls it), and the mesh's first rank
writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.host import BF16_HOST, from_host
from repro_torch.utils.host import to_host as _host

_BF16 = "bfloat16"


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == BF16_HOST else str(arr.dtype)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_path(tree, prefix: str = "") -> list:
    """[(path key, leaf)] in the reference's key format; None is an empty
    subtree, as in jax."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten_with_path(v, f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _map_leaves(fn, tree, prefix: str = ""):
    """Rebuild ``tree`` with each leaf replaced by ``fn(path key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(fn, v, f"{prefix}.{name}")
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _gathered(tree):
    """(path-keyed leaves with every DTensor gathered whole, the mesh of
    the first DTensor or None)."""
    mesh, out = None, []
    for k, v in _flatten_with_path(tree):
        if hasattr(v, "full_tensor"):
            mesh = mesh if mesh is not None else v.device_mesh
            v = v.full_tensor()
        out.append((k, v))
    return out, mesh


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomic checkpoint write of a tree of tensors or arrays.  Returns the
    final path."""
    leaves, mesh = _gathered(tree)
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if mesh is not None and mesh.size() > 1:  # one writer; the rest wait
        if dist.get_rank() == int(mesh.mesh.flatten()[0]):
            _write(ckpt_dir, step, leaves)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, leaves)


def _write(ckpt_dir: str, step: int, leaves) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _host(v) for k, v in leaves}
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}}
    for i, (key, arr) in enumerate(sorted(flat.items())):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["arrays"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": _dtype_name(arr),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _validate(path: str, verify_crc: bool = False):
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        for meta in manifest["arrays"].values():
            ap = os.path.join(path, meta["file"])
            if not os.path.exists(ap):
                return None
            if verify_crc:
                arr = np.load(ap)
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                        != meta["crc32"]:
                    return None
        return manifest
    except (OSError, EOFError, ValueError, KeyError, TypeError):
        return None


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith("step_"):
            steps.append((int(name.split("_")[1]),
                          os.path.join(ckpt_dir, name)))
    return sorted(steps)


def restore_flat(ckpt_dir: str, *, verify_crc: bool = True):
    """(step, {path key: np.ndarray}) from the newest VALID checkpoint, or
    None.  Corrupt or partial checkpoints are skipped."""
    for step, path in reversed(list_checkpoints(ckpt_dir)):
        manifest = _validate(path, verify_crc=verify_crc)
        if manifest is None:
            continue
        flat = {key: np.load(os.path.join(path, meta["file"]))
                for key, meta in manifest["arrays"].items()}
        return step, flat
    return None


def restore_into(ckpt_dir: str, target_tree, *, shardings=None,
                 verify_crc: bool = True):
    """Restore into the structure of ``target_tree``: each leaf comes back
    with the target leaf's dtype, as a tensor on the target tensor's
    device (or an array where the target holds an array).  ``shardings``
    (a tree of the target's structure) re-shards every leaf under the
    current mesh: each rank keeps its own block, and nothing is sent."""
    got = restore_flat(ckpt_dir, verify_crc=verify_crc)
    if got is None:
        return None
    step, flat = got

    def leaf(key, like):
        if key not in flat:
            raise KeyError(f"checkpoint missing array '{key}'")
        if isinstance(like, torch.Tensor):
            return from_host(flat[key], like.device, like.dtype)
        return np.asarray(flat[key], dtype=np.asarray(like).dtype)

    tree = _map_leaves(leaf, target_tree)
    if shardings is not None:
        placed = dict(_flatten_with_path(shardings))
        if placed.keys() != dict(_flatten_with_path(tree)).keys():
            raise ValueError("shardings tree does not match the target's")
        tree = _map_leaves(lambda key, a: placed[key].place(a), tree)
    return step, tree


def gc_checkpoints(ckpt_dir: str, keep: int = 3):
    for _, path in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# Session parking-lot persistence (sessions/service.SlotGridService)
# ---------------------------------------------------------------------------

_META_KEY = "__meta__"
_DTYPES_KEY = "__dtypes__"


def _np_dtype(name: str) -> np.dtype:
    if name == _BF16:
        return BF16_HOST
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(
            f"spill holds dtype {name!r}, which numpy cannot name without "
            "ml_dtypes; the port reads native dtypes and bfloat16 only") \
            from None


def _flatten_parking(parking: dict) -> dict:
    flat = {}

    def rec(prefix: str, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                rec(f"{prefix}/{k}", v)
        else:
            flat[prefix] = _host(obj)

    for sid, tree in parking.items():
        rec(str(int(sid)), tree)
    return flat


def save_sessions(path: str, parking: dict, meta: dict | None = None) -> str:
    """Atomically spill a session parking lot (+ optional metadata).

    Every sid must contribute at least one array: a blob that flattens to
    nothing would vanish from the npz and the restore would drop the
    session instead of refusing."""
    flat = _flatten_parking(parking)
    seen = {key.split("/", 1)[0] for key in flat}
    empty = [sid for sid in parking if str(int(sid)) not in seen]
    if empty:
        raise ValueError(f"session blobs with no arrays cannot round-trip "
                         f"through npz: sids {sorted(empty)}")
    dtypes = {k: _BF16 for k, a in flat.items() if a.dtype == BF16_HOST}
    if dtypes:
        meta = {**(meta or {}), _DTYPES_KEY: dtypes}
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def load_sessions(path: str):
    """Restore (parking, meta) written by ``save_sessions`` of either
    package.  Leaves come back as numpy arrays (0-d for scalars), bfloat16
    as ``BF16_HOST`` bits; nibble-packed leaves keep their {"u4c",
    "scale"} record shape, which sessions/state.unpack_slot decodes."""
    parking: dict[int, dict] = {}
    meta = None
    with np.load(path) as z:
        dtypes = {}
        if _META_KEY in z.files:
            meta = json.loads(bytes(z[_META_KEY]).decode())
            dtypes = meta.pop(_DTYPES_KEY, {})
        for key in z.files:
            if key == _META_KEY:
                continue
            arr = z[key]
            if key in dtypes:
                arr = arr.view(_np_dtype(dtypes[key]))
            parts = key.split("/")
            node = parking.setdefault(int(parts[0]), {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return parking, meta


class AsyncCheckpointer:
    """Snapshot-on-call (device to host on the caller's thread),
    serialize-in-background checkpoint writer."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None

    def save_async(self, step: int, tree):
        """Snapshot ``tree`` (every DTensor gathered whole, on every rank
        of its mesh) and write it in the background: on a mesh of more
        than one rank only its first rank writes."""
        leaves, mesh = _gathered(tree)
        if mesh is not None and mesh.size() > 1 \
                and dist.get_rank() != int(mesh.mesh.flatten()[0]):
            return
        whole = dict(leaves)
        snapshot = _map_leaves(lambda k, _: _host(whole[k]), tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, snapshot), daemon=True)
        self._thread.start()

    def _write(self, step, snapshot):
        save(self.ckpt_dir, step, snapshot)
        gc_checkpoints(self.ckpt_dir, self.keep)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
