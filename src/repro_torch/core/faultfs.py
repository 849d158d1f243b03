"""FaultFS — the injectable I/O shim every persistence site routes through.

Every crash the chaos harness could inject before this module was a POLITE
one: the node was killed *between* operations, after every buffered write
had landed.  Real stores lose acked data to the other kind — kill -9 in
the middle of an fsync, a torn sector, a rename whose directory entry
never reached the platter.  FaultFS makes that kind enumerable:

  * Every mutating I/O op (write / truncate / fsync / replace / remove /
    dirsync) is numbered in program order.  A recording run yields the
    sweep domain; `arm(after=k)` kills the process state at op *k*.
  * Two views per file.  The VOLATILE view is the real file on disk —
    wrapped handles are raw (unbuffered) and write through, so a handle
    abandoned without close() can never flush anything later.  The
    DURABLE view is a per-file shadow advanced only by fsync.
  * Crash = `SimulatedCrash` raised *before* op k executes (kill -9: the
    op never happens).  `materialize(scope)` then rewrites every file
    under the crashed node's directory to its durable view:
      drop         unsynced bytes vanish entirely,
      torn         a deterministic sector-aligned prefix of the unsynced
                   tail survives (crash mid-fsync),
      lost_rename  drop + any os.replace whose parent directory was not
                   fsynced afterwards is undone (dst reverts, src
                   reappears with its durable content).
    Files that never existed durably are removed.  All of it is a pure
    function of {seed, crash op index, mode} — a sweep record replays.

SimulatedCrash subclasses BaseException so a stray `except Exception`
recovery helper cannot swallow a kill -9 and keep the "dead" node running.

When no FaultFS is installed the module-level helpers are exact
pass-throughs (plain buffered open / os.fsync / os.replace), so the hot
path pays nothing.  `write_json_atomic` is the one behavioral export: the
audited metadata-commit pattern (tmp -> fsync(tmp) -> rename -> fsync of
the parent directory) used by every manifest/state/meta file — skipping
the tmp fsync can surface an empty file *after* the rename, skipping the
dirsync can lose the rename itself.

Copied from ``src/repro/core/faultfs.py``; only the import prefix differs.
"""
from __future__ import annotations

import builtins
import json
import os
import random
from typing import Dict, List, Optional

from repro_torch.core import trace as _trace

MODES = ("drop", "torn", "lost_rename")


class SimulatedCrash(BaseException):
    """kill -9 at a numbered I/O op.  BaseException on purpose: broad
    `except Exception` clauses in recovery helpers must not swallow it."""

    def __init__(self, op_index: int, kind: str, path: str):
        super().__init__(
            f"simulated kill -9 at io op {op_index} ({kind} {path})")
        self.op_index = op_index
        self.kind = kind
        self.path = path


_ACTIVE: Optional["FaultFS"] = None


def active() -> Optional["FaultFS"]:
    return _ACTIVE


def install(fs: "FaultFS") -> "FaultFS":
    global _ACTIVE
    _ACTIVE = fs
    return fs


def uninstall():
    global _ACTIVE
    _ACTIVE = None


def _under(path: str, scope: str) -> bool:
    """Prefix scope match; a scope ending in os.sep binds to a directory
    (so node1/ can never match node10), otherwise it is a filename-stem
    prefix (…/valuelog matches valuelog_m0003.log)."""
    if not scope:
        return True
    return path.startswith(scope)


def _norm_scope(scope: str) -> str:
    """abspath that PRESERVES a trailing os.sep (abspath strips it, which
    would turn a directory-bound scope back into a stem prefix)."""
    if not scope:
        return ""
    bound = scope.endswith(os.sep)
    scope = os.path.abspath(scope)
    return scope + os.sep if bound else scope


class FaultFS:
    """One crash experiment: op numbering + shadow tracking + the armed
    crash point.  Install via faultfs.install(); every fs_* helper then
    routes through this instance."""

    def __init__(self, seed: int = 0, sector: int = 128):
        self.seed = seed
        self.sector = sector
        self.op_count = 0
        self.ops_by_kind: Dict[str, int] = {}
        # durable view per abspath: bytes, or None = durably absent
        self._durable: Dict[str, Optional[bytes]] = {}
        # renames not yet covered by a parent-directory fsync
        self._renames: List[dict] = []
        self._armed: Optional[dict] = None
        self._crash_mode = "drop"
        self.last_crash: Optional[SimulatedCrash] = None
        # live wrapped handles: kill -9 takes the fds with it, so
        # materialize() force-closes handles under its scope (and long
        # sweeps abandoning crashed engines leak no descriptors)
        self._open_files: List["_FaultFile"] = []
        self.injected = {"crashes": 0, "dropped_bytes": 0,
                         "torn_tails": 0, "lost_renames": 0}

    # ------------------------------------------------------------ arming
    def arm(self, after: int, *, scope: str = "", mode: str = "drop"):
        """Let `after` more ops under `scope` complete, then crash on the
        next one with `mode` semantics.  Single-shot: disarms on fire."""
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self._armed = {"left": after,
                       "scope": _norm_scope(scope),
                       "mode": mode}

    def disarm(self):
        self._armed = None

    @property
    def armed(self) -> bool:
        return self._armed is not None

    def _op(self, kind: str, path: str) -> int:
        idx = self.op_count
        self.op_count += 1
        self.ops_by_kind[kind] = self.ops_by_kind.get(kind, 0) + 1
        a = self._armed
        if a is not None and _under(path, a["scope"]):
            if a["left"] <= 0:
                self._armed = None
                self._crash_mode = a["mode"]
                self.injected["crashes"] += 1
                self.last_crash = SimulatedCrash(idx, kind, path)
                raise self.last_crash
            a["left"] -= 1
        return idx

    # ---------------------------------------------------------- tracking
    def _baseline(self, path: str):
        """First sighting of a file: whatever is on disk is durable (the
        previous crash/boot already settled it)."""
        if path not in self._durable:
            if os.path.exists(path):
                with builtins.open(path, "rb") as f:
                    self._durable[path] = f.read()
            else:
                self._durable[path] = None

    # -------------------------------------------------------- operations
    def open(self, path: str, mode: str) -> "_FaultFile":
        path = os.path.abspath(path)
        self._baseline(path)
        return _FaultFile(self, path, mode)

    def fsync(self, target):
        """fsync a wrapped file or a path: volatile view becomes durable.
        No real os.fsync is issued — the crash is simulated, the shadow is
        the platter."""
        path = target if isinstance(target, str) else target.path
        path = os.path.abspath(path)
        self._op("fsync", path)
        if os.path.exists(path):
            with builtins.open(path, "rb") as f:
                self._durable[path] = f.read()
        else:
            self._durable[path] = None

    def replace(self, src: str, dst: str):
        src, dst = os.path.abspath(src), os.path.abspath(dst)
        self._op("replace", dst)
        self._baseline(src)
        self._baseline(dst)
        self._renames.append({"dir": os.path.dirname(dst),
                              "src": src, "dst": dst,
                              "src_durable": self._durable.get(src),
                              "dst_durable": self._durable.get(dst)})
        os.replace(src, dst)
        # the rename carries src's INODE: dst's durable content is whatever
        # of src was synced (maybe nothing — the classic missing-tmp-fsync)
        self._durable[dst] = self._durable.get(src)
        self._durable[src] = None

    def remove(self, path: str):
        path = os.path.abspath(path)
        self._op("remove", path)
        if os.path.exists(path):
            os.remove(path)
        self._durable[path] = None   # unlink modeled as immediately durable

    def dirsync(self, dirpath: str):
        """Parent-directory fsync: pending renames under it become
        durable (can no longer be lost)."""
        d = os.path.abspath(dirpath)
        self._op("dirsync", os.path.join(d, ""))
        self._renames = [r for r in self._renames if r["dir"] != d]

    def truncate(self, path: str, size: int):
        path = os.path.abspath(path)
        self._op("truncate", path)

    # ----------------------------------------------------------- crashes
    def materialize(self, scope: str = "", mode: Optional[str] = None) -> int:
        """Apply kill -9 to every tracked file under `scope`: rewrite the
        on-disk (volatile) state to the durable view, mode-adjusted; undo
        un-dirsynced renames in lost_rename mode; reset tracking for the
        scope so recovery re-baselines from the crash state.  Returns the
        number of files changed.  Deterministic from
        {seed, crash op index, mode}."""
        scope = _norm_scope(scope)
        mode = mode or self._crash_mode
        at = self.last_crash.op_index if self.last_crash else self.op_count
        rng = random.Random(f"faultfs:{self.seed}:{at}:{mode}")
        changed = 0
        for fh in [fh for fh in self._open_files if _under(fh.path, scope)]:
            fh.close()               # the dead process's fds go with it
        if mode == "lost_rename":
            undo = [r for r in self._renames if _under(r["dst"], scope)]
            for r in reversed(undo):
                self._write_state(r["dst"], r["dst_durable"])
                self._durable[r["dst"]] = r["dst_durable"]
                if r["src_durable"] is not None:
                    self._write_state(r["src"], r["src_durable"])
                    self._durable[r["src"]] = r["src_durable"]
                self.injected["lost_renames"] += 1
                changed += 1
        for path in sorted(p for p in self._durable if _under(p, scope)):
            durable = self._durable[path]
            current: Optional[bytes] = None
            if os.path.exists(path):
                with builtins.open(path, "rb") as f:
                    current = f.read()
            target = durable
            if mode == "torn" and current is not None:
                base = durable if durable is not None else b""
                if current[:len(base)] == base and len(current) > len(base):
                    extra = current[len(base):]
                    nsec = -(-len(extra) // self.sector)
                    keep = min(len(extra),
                               rng.randrange(nsec + 1) * self.sector)
                    if keep:
                        target = base + extra[:keep]
                        self.injected["torn_tails"] += 1
            if target != current:
                self._write_state(path, target)
                self.injected["dropped_bytes"] += max(
                    0, len(current or b"") - len(target or b""))
                changed += 1
        self._durable = {p: v for p, v in self._durable.items()
                         if not _under(p, scope)}
        self._renames = [r for r in self._renames
                         if not _under(r["dst"], scope)]
        self._armed = None
        return changed

    @staticmethod
    def _write_state(path: str, data: Optional[bytes]):
        """Set the raw on-disk state (bypasses op counting/tracking)."""
        if data is None:
            if os.path.exists(path):
                os.remove(path)
        else:
            with builtins.open(path, "wb") as f:
                f.write(data)

    def counters(self) -> dict:
        return {"io_ops": self.op_count, **self.injected}


class _FaultFile:
    """Write-through wrapper: a raw (unbuffered) handle, so the volatile
    view IS the file on disk and dropping the handle without close() —
    kill -9 — can never flush anything afterwards.  Mutations are
    numbered/armed through the owning FaultFS."""

    def __init__(self, fs: FaultFS, path: str, mode: str):
        if "b" not in mode:
            raise ValueError(f"FaultFS wraps binary files only, got {mode!r}")
        self.fs = fs
        self.path = path
        self._raw = builtins.open(path, mode, buffering=0)
        fs._open_files.append(self)

    def write(self, data) -> int:
        if data:
            self.fs._op("write", self.path)
            self._raw.write(data)
        return len(data)

    def truncate(self, size: Optional[int] = None) -> int:
        if size is None:
            size = self._raw.tell()
        self.fs.truncate(self.path, size)
        return self._raw.truncate(size)

    def read(self, n: int = -1) -> bytes:
        return self._raw.read(n)

    def seek(self, pos: int, whence: int = 0) -> int:
        return self._raw.seek(pos, whence)

    def tell(self) -> int:
        return self._raw.tell()

    def fileno(self) -> int:
        return self._raw.fileno()

    def flush(self):
        pass          # raw handle: every write already landed

    def close(self):
        if self in self.fs._open_files:
            self.fs._open_files.remove(self)
        self._raw.close()

    @property
    def closed(self) -> bool:
        return self._raw.closed

    def __enter__(self) -> "_FaultFile":
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------- pass-through
def fs_open(path: str, mode: str = "rb"):
    """open() for persistence sites.  Read-only handles are never wrapped
    (reads see the volatile view either way)."""
    if _ACTIVE is None or not any(c in mode for c in "wa+"):
        return builtins.open(path, mode)
    return _ACTIVE.open(path, mode)


def fs_fsync(f):
    """fsync an open (wrapped or plain) file."""
    if isinstance(f, _FaultFile):
        f.fs.fsync(f)
    else:
        f.flush()
        os.fsync(f.fileno())


def fs_fsync_path(path: str):
    """fsync a file by path (e.g. sealed run data before its meta commits)."""
    if _trace._ACTIVE is not None:
        _trace._ACTIVE.io("fsync_path", os.path.basename(path), 0)
    if _ACTIVE is not None:
        _ACTIVE.fsync(path)
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fs_replace(src: str, dst: str):
    if _trace._ACTIVE is not None:
        _trace._ACTIVE.io("rename", os.path.basename(dst), 0)
    if _ACTIVE is not None:
        _ACTIVE.replace(src, dst)
    else:
        os.replace(src, dst)


def fs_remove(path: str):
    if _ACTIVE is not None:
        _ACTIVE.remove(path)
    elif os.path.exists(path):
        os.remove(path)


def fs_dirsync(dirpath: str):
    """fsync a directory: makes renames/creations inside it durable."""
    if _trace._ACTIVE is not None:
        _trace._ACTIVE.io("dirsync", os.path.basename(dirpath) or ".", 0)
    if _ACTIVE is not None:
        _ACTIVE.dirsync(dirpath)
        return
    fd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, obj):
    """The audited metadata-commit pattern, used by runs_manifest.json,
    gc_state.json, raft_meta.json and every run .meta file:

        write tmp -> fsync(tmp) -> os.replace -> fsync(parent dir)

    fsyncing the tmp file prevents the rename from exposing an empty or
    torn file; fsyncing the parent directory prevents the rename itself
    from being lost (FaultFS's lost_rename mode exercises exactly these
    two omissions).  Byte accounting stays with the caller."""
    tmp = path + ".tmp"
    f = fs_open(tmp, "wb")
    try:
        f.write(json.dumps(obj).encode())
        fs_fsync(f)
    finally:
        f.close()
    fs_replace(tmp, path)
    fs_dirsync(os.path.dirname(path) or ".")
