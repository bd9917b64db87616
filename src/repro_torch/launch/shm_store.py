"""Shared-memory graph store + cross-process mailboxes for the multiproc
runtime (``repro_torch.launch.multiproc``).

Two primitives, both over ``multiprocessing.shared_memory``:

:class:`ShmArena`
    One segment holding a named tree of numpy arrays. Rank 0 (the builder
    process) publishes the partition-time arrays — padded features/labels/
    masks, the CSR-derived COO triples, the stacked bucketed-ELL layouts
    and the halo plans — exactly once; every worker attaches read-only
    views and device-copies only its own rank's slice. The kernel shares
    the physical pages, so P co-located workers cost one partition copy
    (the DGL ``dist_graph`` shared-store shape), and the untouched other
    ranks' slices never even fault in.

:class:`Mailboxes`
    A fixed-layout message board realizing the exchange schedule's
    collectives across processes: one preallocated byte slot plus an int64
    sequence counter per (op, src->dst) pair. A writer copies its chunk and
    bumps the counter; the reader spins (sched_yield, then a short sleep —
    the container may have fewer cores than ranks) until the counter
    reaches its own execution count for that op. There is no ack channel:
    the per-epoch gradient all-reduce is a full barrier, so epoch ``e``'s
    slots are provably drained before epoch ``e+1`` overwrites them, and
    every rank executes the ops of one epoch in the same data-dependency
    order (a Kahn network — no deadlock, no reordering).

    Word 0 of the counter region is a control word: the parent sets it to
    ``CTRL_ABORT`` when the run is dead (survivors blocked in a wait raise
    :class:`TransportAborted` instead of spinning forever) or to
    ``CTRL_RECOVER`` to quiesce survivors for fault recovery (they raise
    :class:`TransportRecover`, unwind to their command loop, and await a
    restore). Words ``1..nprocs`` are per-rank heartbeat counters: every
    mailbox op (and every spin iteration of a blocked wait) bumps the
    caller's word, so the parent can tell a *hung* worker (stale
    heartbeat, process alive) from one that is merely waiting on a slow
    peer (heartbeat advancing) or dead (exitcode).

Ordering note: the write-buffer-then-bump-counter protocol relies on
x86-TSO store ordering (CPython additionally serializes through the GIL
on each side); the counters have a single writer each, so the unlocked
``+= 1`` is safe.

Cleanup: segments created in this process register in a module registry
and unlink on ``close_all_segments`` or interpreter exit (atexit).
Spawned workers share the parent's ``resource_tracker`` process (the
tracker fd rides in the spawn preparation data), and its name cache is a
set — the children's attach-time registrations collapse into the parent's
create-time one, the parent's unlink retires it exactly once, and if the
whole family dies without cleanup the shared tracker unlinks the leftovers
itself. (The bpo-39959 ``unregister`` workaround is for *unrelated*
attaching processes with their own trackers; applying it here would
double-remove from the shared set.) :func:`leaked_segments` inspects
``/dev/shm`` so tests and CI can fail a run that leaves segments behind.
"""

from __future__ import annotations

import argparse
import atexit
import os
import re
import time
from multiprocessing import shared_memory
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SEG_DIR = "/dev/shm"
_ALIGN = 64

# Control-word states (word 0 of the mailbox counter region).
CTRL_RUN = 0
CTRL_ABORT = 1
CTRL_RECOVER = 2


class TransportAborted(RuntimeError):
    """The parent flagged the run dead (a sibling worker exited)."""


class TransportRecover(RuntimeError):
    """The parent flagged fault recovery: unwind to the command loop and
    await a restore (the run itself is still alive)."""


class TransportTimeout(RuntimeError):
    """A mailbox wait exceeded its deadline (hung or dead peer)."""


def rss_bytes() -> int:
    """This process's resident set size, from /proc (0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def leaked_segments(token: str) -> List[str]:
    """Names under /dev/shm containing ``token`` (leak detector)."""
    try:
        return sorted(n for n in os.listdir(SEG_DIR) if token in n)
    except OSError:
        return []


# Segments created (not merely attached) by this process, for cleanup.
_CREATED: Dict[str, shared_memory.SharedMemory] = {}


def _register_created(shm: shared_memory.SharedMemory) -> None:
    _CREATED[shm.name] = shm


def unlink_segment(name: str) -> None:
    shm = _CREATED.pop(name, None)
    if shm is None:
        return
    try:
        shm.close()
    except BufferError:
        pass  # exported views still alive; unlink below still removes the file
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


def close_all_segments() -> None:
    for name in list(_CREATED):
        unlink_segment(name)


atexit.register(close_all_segments)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


# --------------------------------------------------------------------------
# ShmArena: one segment of named arrays (the shared graph store)
# --------------------------------------------------------------------------


class ShmArena:
    """A named tree of numpy arrays in one shared-memory segment."""

    def __init__(self, shm: shared_memory.SharedMemory,
                 table: Dict[str, dict], owner: bool):
        self.shm = shm
        self.table = table
        self.owner = owner

    @property
    def name(self) -> str:
        return self.shm.name

    @property
    def nbytes(self) -> int:
        return self.shm.size

    @staticmethod
    def layout(arrays: Dict[str, np.ndarray]) -> Tuple[Dict[str, dict], int]:
        table: Dict[str, dict] = {}
        off = 0
        for path in sorted(arrays):
            a = arrays[path]
            table[path] = {"offset": off, "shape": list(a.shape),
                           "dtype": str(a.dtype)}
            off += _aligned(a.nbytes)
        return table, max(off, 1)

    @classmethod
    def publish(cls, name: str, arrays: Dict[str, np.ndarray]) -> "ShmArena":
        table, total = cls.layout(arrays)
        shm = shared_memory.SharedMemory(create=True, size=total, name=name)
        _register_created(shm)
        arena = cls(shm, table, owner=True)
        for path, a in arrays.items():
            arena.view(path)[...] = a
        return arena

    @classmethod
    def attach(cls, name: str, table: Dict[str, dict]) -> "ShmArena":
        return cls(shared_memory.SharedMemory(name=name), table, owner=False)

    def view(self, path: str) -> np.ndarray:
        e = self.table[path]
        return np.ndarray(tuple(e["shape"]), dtype=np.dtype(e["dtype"]),
                          buffer=self.shm.buf, offset=e["offset"])

    def views(self) -> Dict[str, np.ndarray]:
        return {p: self.view(p) for p in self.table}

    def close(self) -> None:
        if self.owner:
            unlink_segment(self.shm.name)
        else:
            try:
                self.shm.close()
            except BufferError:
                pass  # live views; the owner's unlink still reclaims it


# --------------------------------------------------------------------------
# Mailboxes: per-(op, src->dst) slots + seq counters (the wire)
# --------------------------------------------------------------------------


def plan_mailbox(op_table: Sequence[dict], nprocs: int = 0) -> dict:
    """Compute the mailbox segment layout from an op table.

    ``op_table`` rows are ``{"id": str, "pairs": [[src, dst, nbytes],...]}``
    with every rank deriving the identical table from the spec. Returns a
    JSON-able layout: counter word 0 is the control word, words
    ``1..nprocs`` are the per-rank heartbeat counters, then one seq word
    and one aligned byte slot per pair.
    """
    slots: Dict[str, Dict[str, list]] = {}
    seq_idx = 1 + nprocs  # word 0 = control, 1..nprocs = heartbeats
    off = 0
    for op in op_table:
        entry: Dict[str, list] = {}
        for src, dst, nbytes in op["pairs"]:
            entry[f"{src}:{dst}"] = [seq_idx, off, int(nbytes)]
            seq_idx += 1
            off += _aligned(int(nbytes))
        slots[op["id"]] = entry
    seq_bytes = _aligned(8 * seq_idx)
    return {"seq_words": seq_idx, "seq_bytes": seq_bytes, "hb_words": nprocs,
            "data_bytes": max(off, 1), "bytes": seq_bytes + max(off, 1),
            "slots": slots}


class Mailboxes:
    """One rank's handle on the mailbox segment (see module docstring)."""

    def __init__(self, shm: shared_memory.SharedMemory, layout: dict,
                 rank: int, owner: bool, wait_timeout_s: float = 120.0):
        self.shm = shm
        self.rank = rank
        self.owner = owner
        self.timeout = wait_timeout_s
        self._seq = np.ndarray((layout["seq_words"],), dtype=np.int64,
                               buffer=shm.buf)
        self._hb_words = int(layout.get("hb_words", 0))
        self._data = np.ndarray((layout["data_bytes"],), dtype=np.uint8,
                                buffer=shm.buf, offset=layout["seq_bytes"])
        # (op, src, dst) -> (seq word, data offset, slot bytes)
        self._slots: Dict[Tuple[str, int, int], Tuple[int, int, int]] = {}
        for op_id, pairs in layout["slots"].items():
            for key, (si, off, nb) in pairs.items():
                s, d = key.split(":")
                self._slots[(op_id, int(s), int(d))] = (si, off, nb)
        self._count: Dict[str, int] = {}
        self.wait_s = 0.0
        self.bytes_written = 0

    @classmethod
    def create(cls, name: str, layout: dict) -> "Mailboxes":
        shm = shared_memory.SharedMemory(create=True, size=layout["bytes"],
                                         name=name)
        _register_created(shm)
        np.ndarray((layout["seq_words"],), dtype=np.int64,
                   buffer=shm.buf)[...] = 0
        return cls(shm, layout, rank=-1, owner=True)

    @classmethod
    def attach(cls, name: str, layout: dict, rank: int,
               wait_timeout_s: float = 120.0) -> "Mailboxes":
        return cls(shared_memory.SharedMemory(name=name), layout, rank=rank,
                   owner=False, wait_timeout_s=wait_timeout_s)

    # -- control word + heartbeats ----------------------------------------

    def abort(self) -> None:
        self._seq[0] = CTRL_ABORT

    def recover(self) -> None:
        """Flag fault recovery: blocked survivors unwind to their command
        loop via :class:`TransportRecover` instead of dying."""
        self._seq[0] = CTRL_RECOVER

    def clear_ctrl(self) -> None:
        self._seq[0] = CTRL_RUN

    @property
    def ctrl(self) -> int:
        return int(self._seq[0])

    @property
    def aborted(self) -> bool:
        return self._seq[0] == CTRL_ABORT

    def heartbeat(self) -> None:
        """Bump this rank's liveness counter (no-op for the parent or when
        the layout reserved no heartbeat words)."""
        if 0 <= self.rank < self._hb_words:
            self._seq[1 + self.rank] += 1

    def heartbeats(self) -> List[int]:
        """All ranks' heartbeat counters (parent-side monitor)."""
        return [int(self._seq[1 + r]) for r in range(self._hb_words)]

    def _check_ctrl(self, what: str) -> None:
        c = self._seq[0]
        if c == CTRL_ABORT:
            raise TransportAborted(f"run aborted while {what}")
        if c == CTRL_RECOVER:
            raise TransportRecover(f"recovery flagged while {what}")

    # -- recovery resets ---------------------------------------------------

    def reset_counts(self) -> None:
        """Parent-side: zero every seq word, heartbeat and the control word
        while the fleet is quiesced, so respawned and surviving ranks agree
        the wire is empty again."""
        self._seq[...] = 0

    def reset_local(self) -> None:
        """Worker-side: forget per-op execution counts (pairs with the
        parent's :meth:`reset_counts` during recovery)."""
        self._count.clear()

    # -- the wire ----------------------------------------------------------

    def post(self, op: str, dst: int, payload: np.ndarray) -> None:
        """Copy ``payload`` (any dtype, C-contiguous) into the (op,
        self->dst) slot and publish it by bumping the slot's counter."""
        si, off, nb = self._slots[(op, self.rank, dst)]
        buf = payload.reshape(-1).view(np.uint8)
        if buf.nbytes != nb:
            raise ValueError(f"{op}: slot {self.rank}->{dst} holds {nb} "
                             f"bytes, payload is {buf.nbytes}")
        self._data[off:off + nb] = buf
        self._seq[si] = self._count.get(op, 0) + 1
        self.bytes_written += nb
        self.heartbeat()

    def collect(self, op: str, src: int) -> np.ndarray:
        """Wait for the current execution's (op, src->self) payload and
        return a private uint8 copy of it."""
        si, off, nb = self._slots[(op, src, self.rank)]
        want = self._count.get(op, 0) + 1
        t0 = time.perf_counter()
        spins = 0
        while self._seq[si] < want:
            self._check_ctrl(f"waiting on {op} from rank {src}")
            self.heartbeat()
            spins += 1
            if spins < 256:
                os.sched_yield()
            else:
                time.sleep(2e-4)
            if time.perf_counter() - t0 > self.timeout:
                raise TransportTimeout(
                    f"rank {self.rank} waited {self.timeout:.0f}s on {op} "
                    f"from rank {src} (seq {int(self._seq[si])} < {want})")
        self.wait_s += time.perf_counter() - t0
        return self._data[off:off + nb].copy()

    def complete(self, op: str) -> None:
        """Mark one execution of ``op`` done (advances both directions)."""
        self._count[op] = self._count.get(op, 0) + 1

    def close(self) -> None:
        if self.owner:
            unlink_segment(self.shm.name)
        else:
            try:
                self.shm.close()
            except BufferError:
                pass


def run_token() -> str:
    """A unique shm-name token for one multiproc run."""
    return f"repromp-{os.getpid()}-{os.urandom(3).hex()}"


def publish_store(token: str, arrays: Dict[str, np.ndarray],
                  op_table: Iterable[dict], nprocs: int = 0,
                  ) -> Tuple[ShmArena, Mailboxes, dict]:
    """Create both segments of a run and return (arena, mailboxes,
    manifest-fragment) — the builder-side entry point."""
    arena = ShmArena.publish(f"{token}-store", arrays)
    layout = plan_mailbox(list(op_table), nprocs=nprocs)
    mailboxes = Mailboxes.create(f"{token}-mail", layout)
    frag = {
        "token": token,
        "store": {"name": arena.name, "bytes": arena.nbytes,
                  "table": arena.table},
        "mailbox": {"name": mailboxes.shm.name, **layout},
    }
    return arena, mailboxes, frag


# --------------------------------------------------------------------------
# Leaked-segment sweeper: python -m repro_torch.launch.shm_store --gc
# --------------------------------------------------------------------------

# run_token() embeds the owner pid, so a sweep can refuse segments whose
# creating process is still alive.
_SEG_NAME_RE = re.compile(r"^(repromp)-(\d+)-[0-9a-f]+-(store|mail)$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def gc_segments(prefix: str = "repromp", dry_run: bool = False,
                ) -> Tuple[List[str], List[str]]:
    """Sweep /dev/shm for run segments whose owner process is gone.

    Returns ``(removed, kept)`` segment names. A segment is removed only
    when its name parses as ``{prefix}-{pid}-{hex}-{store|mail}`` *and*
    ``pid`` no longer exists — live runs and unparseable names are kept
    (never unlink something we can't prove is ours and orphaned).
    """
    removed: List[str] = []
    kept: List[str] = []
    try:
        names = sorted(os.listdir(SEG_DIR))
    except OSError:
        return removed, kept
    for name in names:
        if not name.startswith(prefix + "-"):
            continue
        m = _SEG_NAME_RE.match(name.replace(prefix, "repromp", 1))
        if m is None or _pid_alive(int(m.group(2))):
            kept.append(name)
            continue
        if not dry_run:
            try:
                shm = shared_memory.SharedMemory(name=name)
            except (FileNotFoundError, OSError):
                continue
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                continue
        removed.append(name)
    return removed, kept


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.shm_store",
        description="Shared-memory segment utilities for the multiproc "
                    "runtime.")
    ap.add_argument("--gc", action="store_true",
                    help="unlink run segments whose owner process is dead")
    ap.add_argument("--prefix", default="repromp",
                    help="segment name prefix to sweep (default: repromp)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what --gc would remove without unlinking")
    args = ap.parse_args(argv)
    if not args.gc:
        ap.error("nothing to do (pass --gc)")
    removed, kept = gc_segments(prefix=args.prefix, dry_run=args.dry_run)
    verb = "would remove" if args.dry_run else "removed"
    for name in removed:
        print(f"{verb} {name}")
    for name in kept:
        print(f"kept {name} (owner alive or unrecognized name)")
    if not removed and not kept:
        print(f"no {args.prefix}-* segments under {SEG_DIR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
