"""Checkpointing: crash-safe flat-npz tree save/restore (counterpart of
``repro/checkpoint/ckpt.py``, in its on-disk format).

A tree is a dict, list, tuple or ``NamedTuple`` of trees, with tensors
and Python ints as leaves (``None`` holds no leaf). It is flattened to
key-path strings written exactly as ``jax.tree_util.keystr`` writes them
(``['params']['layers'][0]['w_self']``, ``['opt_state'].step``; dict keys
in sorted order), so the JAX package reads the port's checkpoints and the
port reads the JAX package's. A Python int is stored as an int32 scalar,
the JAX package's dtype of an optimizer step count, and restored as an
int. The manifest records the key set, a per-array sha256 checksum, the
step and caller metadata, so restore rebuilds the exact structure and
*proves* the bytes it read are the bytes that were written. Tensors are
copied to the host; restore puts each leaf on its template leaf's device.

Crash safety: both files of a checkpoint (``.npz`` arrays + ``.json``
manifest) are written to a private temp directory, fsync'd, and renamed
into place **manifest last** — a reader never sees a manifest without its
arrays, and a kill at any instant leaves either the previous checkpoint or
a complete new one. A torn pair (arrays without manifest, or a stale
manifest beside newer arrays) is rejected by the checksum verification
with a :class:`CheckpointCorrupt` error instead of silently restoring
garbage.

:class:`CheckpointManager` adds the periodic-training shape on top: a
directory of step-numbered checkpoints with last-k retention,
``latest()`` discovery for resume, and a corruption-detecting
``load_latest()`` that falls back step by step to the previous good
checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_FORMAT = 1


class CheckpointCorrupt(ValueError):
    """A checkpoint's arrays don't match its manifest (torn write, bit
    rot, or a chaos-injected mutation)."""


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves_with_keys(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(key string, leaf) of every leaf of ``tree``, in
    ``jax.tree_util.tree_leaves_with_path`` order, keyed as ``keystr``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_keys(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_keys(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_keys(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)) or not isinstance(leaf, (int, np.integer)):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: "
                        "tensors and ints only")
    return np.asarray(leaf, np.int32)


def _rebuild(template, values: Iterator):
    """``template``'s structure with its leaves taken from ``values`` in
    :func:`leaves_with_keys` order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], values) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, n), values)
                                for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values) for v in template)
    return next(values)


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in leaves_with_keys(tree)}


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(path: str | Path, tree, step: Optional[int] = None,
                    meta: Optional[dict] = None) -> Path:
    """Atomically write ``tree`` as ``path.npz`` + ``path.json``.

    Both files land in a temp dir first (fsync'd), then rename into place
    arrays-first, manifest **last**: the manifest commits the checkpoint,
    so a crash at any point leaves either the old pair or the new pair,
    never a mix the checksum verification would accept.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "format": MANIFEST_FORMAT,
        "keys": sorted(flat),
        "checksums": {k: _checksum(v) for k, v in flat.items()},
        "step": step,
        "meta": meta or {},
    }
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{path.name}-",
                                dir=path.parent))
    try:
        tmp_npz = tmp / (path.name + ".npz")
        tmp_json = tmp / (path.name + ".json")
        with open(tmp_npz, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp_json, "w") as f:
            f.write(json.dumps(manifest, indent=1))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, path.with_suffix(".npz"))
        os.replace(tmp_json, path.with_suffix(".json"))  # the commit point
        _fsync_dir(path.parent)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path.with_suffix(".npz")


def load_checkpoint(path: str | Path, verify: bool = True) -> dict:
    """-> ``{"arrays": {keypath: np.ndarray}, "manifest": dict}``.

    With ``verify`` (default), every array's sha256 must match the
    manifest — a torn ``.npz``/``.json`` pair or an on-disk mutation
    raises :class:`CheckpointCorrupt` with the offending key.
    """
    path = Path(path)
    npz, man = path.with_suffix(".npz"), path.with_suffix(".json")
    if not man.exists():
        raise FileNotFoundError(f"checkpoint manifest {man} missing "
                                f"(torn write or never committed)")
    try:
        # dict() forces every lazy zip member read here, so any torn or
        # mutated byte surfaces now (CRC) rather than at first access.
        data = dict(np.load(npz, allow_pickle=False))
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(f"{npz}: unreadable arrays file: {e}") from e
    manifest = json.loads(man.read_text())
    missing = set(manifest["keys"]) - set(data)
    extra = set(data) - set(manifest["keys"])
    if missing or extra:
        raise CheckpointCorrupt(
            f"{path}: arrays/manifest key mismatch (torn pair?): "
            f"missing {sorted(missing)[:3]}, unexpected {sorted(extra)[:3]}")
    if verify:
        sums = manifest.get("checksums", {})
        for k, a in data.items():
            want = sums.get(k)
            if want is not None and _checksum(a) != want:
                raise CheckpointCorrupt(
                    f"{path}: checksum mismatch on {k!r} — the arrays on "
                    f"disk are not the arrays this manifest describes")
    return {"arrays": data, "manifest": manifest}


def restore_arrays(arrays: Dict[str, np.ndarray], template):
    """``template``'s structure filled from a loaded checkpoint's
    ``arrays`` (extra arrays are ignored): each tensor leaf with the
    template leaf's dtype and device, each int leaf as an int. Raises
    ``KeyError`` for a missing leaf and ``ValueError`` for a shape
    mismatch."""
    out = []
    for key, leaf in leaves_with_keys(template):
        if key not in arrays:
            raise KeyError(f"checkpoint has no leaf {key}")
        a = arrays[key]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} != template {shape}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype=leaf.dtype, device=leaf.device))
        else:
            out.append(int(a))
    return _rebuild(template, iter(out))


def restore_train_state(path: str | Path, template):
    """Restore into the structure of ``template`` (same tree); returns
    (tree, manifest)."""
    ck = load_checkpoint(path)
    return restore_arrays(ck["arrays"], template), ck["manifest"]


class CheckpointManager:
    """A directory of step-numbered checkpoints with retention + resume.

    Files are ``{prefix}-{step:08d}.npz/.json`` under ``directory``. Every
    :meth:`save` prunes to the newest ``keep`` steps; :meth:`latest`
    discovers the newest committed step; :meth:`load_latest` walks
    newest-to-oldest past corrupt snapshots so a run whose freshest
    checkpoint was torn or mutated resumes from the previous good one.
    """

    _STEP_RE = re.compile(r"-(\d+)\.json$")

    def __init__(self, directory: str | Path, keep: int = 3,
                 prefix: str = "ckpt"):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = Path(directory)
        self.keep = keep
        self.prefix = prefix
        self.dir.mkdir(parents=True, exist_ok=True)

    def path_for(self, step: int) -> Path:
        return self.dir / f"{self.prefix}-{step:08d}"

    def steps(self) -> List[int]:
        """Committed steps (manifest present), ascending."""
        out = []
        for p in self.dir.glob(f"{self.prefix}-*.json"):
            m = self._STEP_RE.search(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, tree, step: int, meta: Optional[dict] = None) -> Path:
        out = save_checkpoint(self.path_for(step), tree, step=step, meta=meta)
        self._prune()
        return out

    def _prune(self) -> None:
        for step in self.steps()[: -self.keep]:
            self.delete(step)

    def delete(self, step: int) -> None:
        base = self.path_for(step)
        # Arrays last: a manifest without arrays is detectably torn, the
        # reverse (arrays without manifest) is just an uncommitted write.
        for suffix in (".json", ".npz"):
            try:
                base.with_suffix(suffix).unlink()
            except FileNotFoundError:
                pass

    def verify(self, step: int) -> bool:
        """True iff the checkpoint at ``step`` loads checksum-clean."""
        try:
            load_checkpoint(self.path_for(step))
            return True
        except (CheckpointCorrupt, FileNotFoundError, OSError,
                ValueError, KeyError):
            return False

    def load_latest(self) -> Tuple[Optional[dict], Optional[int]]:
        """(checkpoint dict, step) of the newest *good* checkpoint, or
        (None, None) when none loads; corrupt snapshots are skipped
        newest-to-oldest (the fallback path)."""
        for step in reversed(self.steps()):
            try:
                return load_checkpoint(self.path_for(step)), step
            except (CheckpointCorrupt, FileNotFoundError, OSError,
                    ValueError, KeyError):
                continue
        return None, None

    def valid_steps(self) -> List[int]:
        """Steps whose checkpoints verify clean, ascending."""
        return [s for s in self.steps() if self.verify(s)]


def latest_common_step(managers: Dict[int, "CheckpointManager"]
                       ) -> Optional[int]:
    """The newest step at which *every* manager holds a checksum-clean
    checkpoint (None when no step is common) — the restore point of a
    multi-rank run, where a partial or corrupt per-rank snapshot must
    drag the whole fleet back to the previous consistent set."""
    common: Optional[set] = None
    for mgr in managers.values():
        steps = set(mgr.valid_steps())
        common = steps if common is None else common & steps
    if not common:
        return None
    return max(common)
