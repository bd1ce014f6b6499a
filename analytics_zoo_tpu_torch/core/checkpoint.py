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

Several processes (``torch.distributed`` initialized, world size > 1):
the JAX package's multi-process layout.  ``save`` is collective: every
process calls it with its tree.  Each array leaf is a sharded entry of
the meta (``{"shape", "dtype", "shards": {index key: owner}, "spec"}``,
the JAX package's ``_index_key`` names and owner rule: a piece is
written by the lowest rank holding it): a :class:`Sharded` leaf brings
its pieces and owners (the estimator's rule-placed leaves), any other
array leaf is one whole piece owned by process 0.  Each process writes
the pieces it owns to ``shards_<gen>_p<i>.npz``; the generation tag is
process 0's, broadcast; a barrier and an allgather of the files' CRCs
over the host group (``core/context.py``) come before process 0 writes
the meta, and a last barrier before anyone returns.  ``restore``
reassembles every sharded leaf whole on the host (from any tiling), so
either package restores the other's checkpoint.
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


class Sharded:
    """An array leaf placed over several processes, as ``save`` writes it:
    its global ``shape`` and ``dtype``, the pieces this process holds
    (``{index key: array or tensor}``), every piece's owner rank and the
    placement's ``spec`` (recorded in the meta)."""

    def __init__(self, shape: Any, dtype: Any, pieces: Dict[str, Any],
                 owners: Dict[str, int], spec: Any = None):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.pieces = pieces
        self.owners = owners
        self.spec = spec


def _whole_key(shape: Tuple[int, ...]) -> str:
    return ",".join(f"0:{d}" for d in shape) if shape else ":"


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return _RAW_TORCH.get(leaf.dtype) or str(leaf.dtype).replace(
            "torch.", "")
    if isinstance(leaf, torch.dtype):
        return _RAW_TORCH.get(leaf) or str(leaf).replace("torch.", "")
    return np.dtype(getattr(leaf, "dtype", leaf)).name


def _world() -> Tuple[int, int]:
    """(rank, world size): ``data.readers.process_grid``, the one source."""
    from ..data.readers import process_grid
    return process_grid()


def _host_group() -> Any:
    from .context import OrcaContext
    import torch.distributed as dist
    g = OrcaContext.host_group
    if g is not None:
        return g
    return None if dist.get_backend() != "gloo" else dist.group.WORLD


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier(group=_host_group())


def _gather_ints(value: int) -> List[int]:
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64)
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(_world()[1])]
    dist.all_gather(parts, t, group=_host_group())
    return [int(p.item()) for p in parts]


def _broadcast_int(value: int) -> int:
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=_host_group())
    return int(t.item())


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
    if _world()[1] > 1:
        return _save_processes(path, leaves, structure, step, extra,
                               retries, retry_delay, t_save)
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


def _save_processes(path: str, leaves: List[Any], structure: Any,
                    step: Optional[int], extra: Optional[dict],
                    retries: int, retry_delay: float, t_save: float) -> str:
    """``save`` over several processes: the JAX package's multi-process
    layout (see the module's doc)."""
    pidx, pcount = _world()
    scalars: List[Any] = []
    shard_meta: List[Any] = []
    mine: Dict[str, np.ndarray] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Sharded):
            entry = {"shape": list(leaf.shape),
                     "dtype": _dtype_name(leaf.dtype),
                     "shards": dict(leaf.owners)}
            if leaf.spec is not None:
                entry["spec"] = [list(e) if isinstance(e, tuple) else e
                                 for e in leaf.spec]
            for key, piece in leaf.pieces.items():
                if leaf.owners.get(key) == pidx:
                    mine[f"a{i}__{key}"] = _npz_safe(piece)[0]
            shard_meta.append(entry)
            scalars.append(None)
        elif _is_array_leaf(leaf):
            shape = tuple(leaf.shape)
            key = _whole_key(shape)
            shard_meta.append({"shape": list(shape),
                               "dtype": _dtype_name(leaf),
                               "shards": {key: 0}})
            if pidx == 0:
                mine[f"a{i}__{key}"] = _npz_safe(leaf)[0]
            scalars.append(None)
        else:
            shard_meta.append(None)
            scalars.append(_encode_scalar(leaf) if pidx == 0 else None)
    gen = f"{_broadcast_int(secrets.randbits(31) if pidx == 0 else 0):08x}"
    crc = [0]

    def _write_shards() -> None:
        fd, tmp = tempfile.mkstemp(dir=path, suffix=f".p{pidx}.tmp")
        with os.fdopen(fd, "wb") as f:
            savez(f, mine)
        crc[0] = _crc32_file(tmp)
        os.replace(tmp, os.path.join(path, _shards_name(gen, pidx)))
        fsync_dir(path)

    _write_with_retry(_write_shards, f"shards p{pidx}", retries, retry_delay)
    _barrier()  # every shard file complete before the meta is visible
    crcs = {_shards_name(gen, p): c & 0xFFFFFFFF
            for p, c in enumerate(_gather_ints(crc[0]))}
    if pidx == 0:
        meta = {"treedef": structure, "scalars": scalars,
                "sharded": shard_meta, "n_leaves": len(leaves),
                "step": step, "gen": gen, "raw_dtypes": {},
                "extra": extra or {}}

        def _write_data_and_meta() -> None:
            fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                savez(f, {})
            meta["crc32"] = dict(crcs, **{_data_name(gen): _crc32_file(tmp)})
            fd, tmp_meta = tempfile.mkstemp(dir=path, suffix=".json.tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(path, _data_name(gen)))
            os.replace(tmp_meta, os.path.join(path, _META))
            fsync_dir(path)

        _write_with_retry(_write_data_and_meta, "data+meta", retries,
                          retry_delay)
        try:
            os.remove(os.path.join(path, _PREV_META))
        except OSError:
            pass
        _gc_stale_generations(path, {gen})
    _barrier()  # nobody returns before the meta names this generation
    metrics_lib.get_registry().observe(
        "checkpoint.save_ms", (time.monotonic() - t_save) * 1000.0)
    return path


def _data_name(gen: Optional[str]) -> str:
    return f"arrays_{gen}.npz" if gen else _DATA


def _shards_name(gen: Optional[str], proc: int) -> str:
    return f"shards_{gen}_p{proc}.npz" if gen else f"shards_p{proc}.npz"


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


def _key_to_index(key: str) -> tuple:
    if key == ":":
        return ()
    return tuple(slice(int(a), int(b))
                 for a, b in (p.split(":") for p in key.split(",")))


def _restore_sharded_leaf(path: str, meta: dict, i: int, entry: dict,
                          files: Dict[int, Any]) -> Any:
    """One sharded entry reassembled whole from every saved piece (any
    tiling); raises if the pieces do not cover it."""
    shape = tuple(entry["shape"])
    name = entry["dtype"]
    raw = name if name in _RAW_BY_NAME else None
    out = np.empty(shape, np.uint16 if raw == "bfloat16" else (
        np.uint8 if raw else np.dtype(name)))
    filled = 0
    for key, proc in entry["shards"].items():
        proc = int(proc)
        if proc not in files:
            fname = _shards_name(meta.get("gen"), proc)
            _verify_crc(path, fname, meta.get("crc32"))
            files[proc] = np.load(os.path.join(path, fname),
                                  allow_pickle=False)
        piece = files[proc][f"a{i}__{key}"]
        idx = _key_to_index(key)
        out[idx] = piece
        filled += int(np.prod(piece.shape)) if shape else 1
    if filled != max(1, int(np.prod(shape))):
        raise ValueError(f"checkpoint shards of leaf {i} cover {filled} of "
                         f"{int(np.prod(shape))} elements")
    return _from_npz(out, raw)


def _restore_from_meta(path: str, meta: dict) -> Any:
    crcs = meta.get("crc32")
    data_name = _data_name(meta.get("gen"))
    _verify_crc(path, data_name, crcs)
    raw_dtypes = meta.get("raw_dtypes") or {}
    shard_meta = meta.get("sharded") or [None] * meta["n_leaves"]
    files: Dict[int, Any] = {}
    leaves = []
    try:
        with np.load(os.path.join(path, data_name),
                     allow_pickle=False) as npz:
            for i in range(meta["n_leaves"]):
                enc = meta["scalars"][i]
                if shard_meta[i] is not None:
                    leaves.append(_restore_sharded_leaf(
                        path, meta, i, shard_meta[i], files))
                elif enc is None:
                    leaves.append(_from_npz(npz[f"a{i}"],
                                            raw_dtypes.get(f"a{i}")))
                else:
                    leaves.append(_decode_scalar(enc))
    finally:
        for f in files.values():
            f.close()
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
