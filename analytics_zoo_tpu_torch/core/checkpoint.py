# Port of analytics_zoo_tpu/core/checkpoint.py: the same on-disk format
# (treedef.json + arrays_<gen>.npz, crc32 per data file, keep=2's
# treedef.prev.json), written and read without JAX.
"""Checkpoint I/O for trees of tensors and arrays.

A tree (nested dicts, lists and tuples) is flattened in the JAX package's
leaf order (dict keys sorted, ``None`` an empty subtree), its array leaves
written to ``arrays_<gen>.npz`` and its structure, scalars and dtypes to
``treedef.json``.  A directory written by either package restores in the
other.

Leaves: a ``torch.Tensor`` (copied to the host) or a numpy array goes into
the npz; ``None``, bools, ints, floats and strings are encoded in the meta.
Dtypes numpy lacks (bfloat16, the float8s) are stored as same-width
unsigned-int bit views with the real dtype named in ``raw_dtypes``, as the
JAX package stores its ml_dtypes arrays; ``restore`` gives such a leaf back
as a torch tensor of that dtype, every other array leaf as a numpy array.

Crash consistency: every save writes its data under a fresh generation
tag and renames ``treedef.json`` (which names the generation) last, then
fsyncs the directory; a kill at any point leaves the previous checkpoint
whole.  Transient ``OSError``s are retried with backoff
(``checkpoint.write_fail`` is the injection point), and stale generations
are collected only after the new meta is visible.

Integrity: ``save`` records a crc32 per data file, and ``restore`` checks
it before trusting the bytes: a mismatch raises
:class:`CheckpointCorruptError` naming the file (and counts
``checkpoint.corrupt_files``), unless ``save(keep=2)`` left the previous
generation, to which restore falls back with a warning.

One process: the port writes the dense layout only.  A meta with a
``sharded`` entry (the JAX package's multi-process layout,
``shards_<gen>_p<i>.npz``) raises ``NotImplementedError``: reading it
comes with sharding (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import tempfile
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults as faults_lib
from . import metrics as metrics_lib

logger = logging.getLogger("analytics_zoo_tpu_torch")

_META = "treedef.json"
_PREV_META = "treedef.prev.json"
_DATA = "arrays.npz"

# torch dtypes numpy has no twin for, by the name ml_dtypes gives them
_RAW_TORCH = {torch.bfloat16: "bfloat16",
              torch.float8_e4m3fn: "float8_e4m3fn",
              torch.float8_e5m2: "float8_e5m2"}
_RAW_BY_NAME = {v: k for k, v in _RAW_TORCH.items()}
_UINT = {1: torch.uint8, 2: torch.int16}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint data file's bytes do not match the crc32 recorded at
    save time (or the file vanished).  The message names the file."""


def fsync_dir(path: str) -> None:
    """fsync a directory so the rename that just landed in it is durable
    (best effort: a filesystem that refuses directory fds keeps the
    rename's own guarantee)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _verify_crc(path: str, name: str, crcs: Optional[Dict[str, int]]
                ) -> None:
    """Check one data file against the crc recorded at save time (a file
    with none recorded passes)."""
    want = (crcs or {}).get(name)
    if want is None:
        return
    full = os.path.join(path, name)
    try:
        got = _crc32_file(full)
    except OSError as e:
        metrics_lib.get_registry().inc("checkpoint.corrupt_files")
        raise CheckpointCorruptError(
            f"checkpoint data file {name!r} in {path} is unreadable: {e}"
        ) from e
    if got != int(want):
        metrics_lib.get_registry().inc("checkpoint.corrupt_files")
        raise CheckpointCorruptError(
            f"checkpoint data file {name!r} in {path} is corrupt: "
            f"crc32 {got:#010x} != recorded {int(want):#010x}")


def _write_with_retry(fn: Callable[[], None], what: str, retries: int,
                      retry_delay: float) -> None:
    """Run a write step, retrying transient OSErrors with exponential
    backoff; ``checkpoint.write_fail`` fires inside each attempt."""
    attempts = max(1, retries)
    for attempt in range(1, attempts + 1):
        try:
            faults_lib.get_registry().raise_if("checkpoint.write_fail",
                                               default_exc=OSError)
            fn()
            return
        except OSError as e:
            if attempt >= attempts:
                raise
            delay = retry_delay * (2 ** (attempt - 1))
            logger.warning(
                "checkpoint write (%s) failed: %s - retry %d/%d in %.2fs",
                what, e, attempt, attempts - 1, delay)
            time.sleep(delay)


def savez(f: Any, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(f, **arrays)``'s file (a stored zip of ``.npy``
    entries, which ``np.load`` reads), with each array's bytes handed to
    the zip writer from the array's own buffer: ``np.savez`` copies them
    through ``tobytes`` in 16 MB chunks under the GIL, which an
    asynchronous writer thread would take from the training loop."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            if not arr.flags.c_contiguous:
                arr = arr.copy(order="C")
            with zf.open(name + ".npy", "w", force_zip64=True) as w:
                np.lib.format.write_array_header_1_0(
                    w, np.lib.format.header_data_from_array_1_0(arr))
                raw = arr.reshape(-1).view(np.uint8)
                for i in range(0, raw.size, 64 << 20):
                    w.write(memoryview(raw[i:i + (64 << 20)]))


# -- leaves ---------------------------------------------------------------------

def _npz_safe(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """An array leaf as what ``np.savez`` round-trips, and the real dtype's
    name when it had to be stored as a bit view (else None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        raw = _RAW_TORCH.get(t.dtype)
        if raw is not None:
            view = t.contiguous().view(_UINT[t.element_size()]).cpu()
            return view.numpy().view(f"uint{8 * t.element_size()}"), raw
        return t.cpu().numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind != "V":
        return arr, None
    try:
        view = arr.view(f"uint{8 * arr.dtype.itemsize}")
    except (TypeError, ValueError) as e:
        raise TypeError(f"cannot checkpoint dtype {arr.dtype.name!r}: {e}"
                        ) from e
    return view, arr.dtype.name


def _from_npz(arr: np.ndarray, name: Optional[str]) -> Any:
    """Undo :func:`_npz_safe`: a bit view named in ``raw_dtypes`` becomes
    a torch tensor of that dtype (numpy has none)."""
    if name is None:
        return arr
    dtype = _RAW_BY_NAME.get(name)
    if dtype is None:
        raise TypeError(f"checkpoint leaf has dtype {name!r}, which this "
                        f"package cannot represent (known: "
                        f"{sorted(_RAW_BY_NAME)})")
    width = dtype.itemsize
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        np.int16 if width == 2 else np.uint8)).view(dtype)


def _is_array_leaf(leaf: Any) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray))


# -- tree flattening (the JAX package's pytree order) ---------------------------

def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, structure)``: leaves in JAX's ``tree_flatten`` order
    (dict keys sorted, lists and tuples in order, ``None`` an empty
    subtree) and the structure as ``treedef.json`` spells it."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if node is None:
            return {"k": "none"}
        if isinstance(node, dict):
            return {"k": "dict",
                    "items": [[k, walk(node[k])]
                              for k in sorted(node, key=str)]}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {"k": kind, "items": [walk(v) for v in node]}
        leaves.append(node)
        return {"k": "leaf", "i": len(leaves) - 1}

    return leaves, walk(tree)


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The tree ``structure`` describes, with ``leaves`` placed by index."""
    k = structure["k"]
    if k == "none":
        return None
    if k == "dict":
        return {key: unflatten(v, leaves) for key, v in structure["items"]}
    if k == "list":
        return [unflatten(v, leaves) for v in structure["items"]]
    if k == "tuple":
        return tuple(unflatten(v, leaves) for v in structure["items"])
    if k == "leaf":
        return leaves[structure["i"]]
    raise ValueError(f"bad treedef spec kind {k}")


def leaf_paths(tree: Any) -> List[str]:
    """Each leaf's ``/``-joined path, in :func:`flatten`'s order."""
    out: List[str] = []

    def walk(node: Any, prefix: str) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append(prefix)

    walk(tree, "")
    return out


# -- save -----------------------------------------------------------------------

def save(path: str, tree: Any, step: Optional[int] = None,
         extra: Optional[dict] = None, retries: int = 3,
         retry_delay: float = 0.05, keep: int = 1) -> str:
    """Write ``tree`` under directory ``path`` (created if needed); returns
    the directory.

    ``retries``/``retry_delay``: transient OSErrors of the data and meta
    writes are retried with exponential backoff.  ``keep``: generations
    kept on disk; ``keep=2`` keeps the previous one's data and meta (as
    ``treedef.prev.json``) so a corrupt newest generation falls back."""
    t_save = time.monotonic()
    leaves, structure = flatten(tree)
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    scalars: List[Any] = []
    raw_dtypes: Dict[str, str] = {}
    for i, leaf in enumerate(leaves):
        if _is_array_leaf(leaf):
            arrays[f"a{i}"], raw = _npz_safe(leaf)
            if raw:
                raw_dtypes[f"a{i}"] = raw
            scalars.append(None)
        else:
            scalars.append(_encode_scalar(leaf))
    gen = f"{secrets.randbits(32):08x}"
    meta = {"treedef": structure, "scalars": scalars, "sharded": None,
            "n_leaves": len(leaves), "step": step, "gen": gen,
            "raw_dtypes": raw_dtypes, "extra": extra or {}}

    def _write_data_and_meta() -> None:
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            savez(f, arrays)
        meta["crc32"] = {_data_name(gen): _crc32_file(tmp)}
        fd, tmp_meta = tempfile.mkstemp(dir=path, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        if keep >= 2:
            # the outgoing meta becomes the fallback generation's, through
            # tmp+rename so a crash leaves the old prev or the new one
            cur = os.path.join(path, _META)
            if os.path.exists(cur):
                fd2, tmp_prev = tempfile.mkstemp(dir=path,
                                                 suffix=".prev.tmp")
                with os.fdopen(fd2, "w") as dst, open(cur) as src:
                    dst.write(src.read())
                os.replace(tmp_prev, os.path.join(path, _PREV_META))
        os.replace(tmp, os.path.join(path, _data_name(gen)))
        os.replace(tmp_meta, os.path.join(path, _META))  # commit point
        fsync_dir(path)

    # a failed attempt leaves only this generation's temp and data files:
    # retrying the whole step is safe at any point
    _write_with_retry(_write_data_and_meta, "data+meta", retries,
                      retry_delay)
    live = {gen}
    prev_file = os.path.join(path, _PREV_META)
    if keep >= 2:
        try:
            with open(prev_file) as f:
                prev_gen = json.load(f).get("gen")
            if prev_gen:
                live.add(prev_gen)
        except (OSError, json.JSONDecodeError):
            pass
    else:
        # keep=1 after a keep>=2 save: the prev meta would dangle
        try:
            os.remove(prev_file)
        except OSError:
            pass
    _gc_stale_generations(path, live)
    metrics_lib.get_registry().observe(
        "checkpoint.save_ms", (time.monotonic() - t_save) * 1000.0)
    return path


def _data_name(gen: Optional[str]) -> str:
    return f"arrays_{gen}.npz" if gen else _DATA


def _gc_stale_generations(path: str, live_gens: set) -> None:
    """Remove data files of superseded saves (after the new meta is
    visible; a crash mid-GC only leaves unreferenced files)."""
    for name in os.listdir(path):
        if ((name.startswith("arrays_") or name.startswith("shards_"))
                and name.endswith(".npz")
                and not any(g in name for g in live_gens)):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


# -- restore --------------------------------------------------------------------

def restore(path: str) -> Any:
    """Load the tree saved at ``path`` (array leaves as numpy arrays, or
    torch tensors for dtypes numpy lacks).

    Every data file read is checked against its recorded crc32; a
    mismatch raises :class:`CheckpointCorruptError` naming the file,
    unless the previous complete generation (``save(keep=2)``) is still
    there, to which restore falls back with a warning."""
    t_restore = time.monotonic()
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    try:
        out = _restore_from_meta(path, meta)
    except CheckpointCorruptError as e:
        prev_meta = None
        try:
            with open(os.path.join(path, _PREV_META)) as f:
                prev_meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
        if prev_meta is None or prev_meta.get("gen") == meta.get("gen"):
            raise
        logger.warning(
            "checkpoint at %s is corrupt (%s); falling back to the "
            "previous complete generation (gen %s, step %s)", path, e,
            prev_meta.get("gen"), prev_meta.get("step"))
        out = _restore_from_meta(path, prev_meta)
    metrics_lib.get_registry().observe(
        "checkpoint.restore_ms", (time.monotonic() - t_restore) * 1000.0)
    return out


def _restore_from_meta(path: str, meta: dict) -> Any:
    if meta.get("sharded"):
        raise NotImplementedError(
            f"checkpoint at {path} is a multi-process save (shards_<gen>_"
            "p<i>.npz); reading that layout is not ported yet (ROADMAP "
            "Queue 1 item 7: it comes with sharding)")
    crcs = meta.get("crc32")
    data_name = _data_name(meta.get("gen"))
    _verify_crc(path, data_name, crcs)
    raw_dtypes = meta.get("raw_dtypes") or {}
    leaves = []
    with np.load(os.path.join(path, data_name), allow_pickle=False) as npz:
        for i in range(meta["n_leaves"]):
            enc = meta["scalars"][i]
            if enc is None:
                leaves.append(_from_npz(npz[f"a{i}"],
                                        raw_dtypes.get(f"a{i}")))
            else:
                leaves.append(_decode_scalar(enc))
    return unflatten(meta["treedef"], leaves)


def load_extra(path: str) -> dict:
    """The caller metadata dict passed to ``save(extra=...)``."""
    try:
        with open(os.path.join(path, _META)) as f:
            return json.load(f).get("extra") or {}
    except (OSError, json.JSONDecodeError):
        return {}


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, _META)) as f:
            return json.load(f).get("step")
    except (OSError, json.JSONDecodeError):
        return None


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, _META))


# -- scalars --------------------------------------------------------------------

def _encode_scalar(leaf: Any) -> Any:
    if leaf is None:
        return {"t": "none"}
    if isinstance(leaf, bool):
        return {"t": "bool", "v": leaf}
    if isinstance(leaf, (int, float, str)):
        return {"t": type(leaf).__name__, "v": leaf}
    if isinstance(leaf, (np.integer, np.floating)):
        return {"t": "float" if isinstance(leaf, np.floating) else "int",
                "v": leaf.item()}
    raise TypeError(f"cannot checkpoint leaf of type {type(leaf)}")


def _decode_scalar(enc: Any) -> Any:
    t = enc["t"]
    if t == "none":
        return None
    return {"bool": bool, "int": int, "float": float, "str": str}[t](enc["v"])
