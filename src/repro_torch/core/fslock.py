"""Best-effort advisory file locking for the persisted caches.

``constraint_cache.json``, ``tuning_cache.json``, the fleet tuner's
``dispatch_table.json`` and its shared lesson store ``lessons.json`` are
shared across worker processes.  ``locked`` takes an *advisory*
``fcntl.flock`` on a sidecar ``<path>.lock`` file — a sidecar, because
the data file itself is replaced whole on save, and a lock on a replaced
inode protects nobody.  A stale sidecar left behind by a killed process
is inert: ``flock`` locks die with their holder, so the next taker just
locks the leftover file.  On platforms without ``fcntl`` (or filesystems
that refuse to lock) it degrades to a no-op: the caches are
merge-on-save and verdict-durable, so the worst unlocked outcome is a
lost cache entry, never a wrong answer.

``merge_save`` is the one shared read-merge-write critical section every
JSON cache save goes through: re-read the merge base *inside* the
exclusive lock, merge, replace the file — so two workers saving
concurrently union their entries instead of the later one clobbering the
earlier's.  ``read_json`` is the matching shared-lock read.
"""
from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

try:
    import fcntl
except ImportError:          # non-POSIX platform
    fcntl = None


@contextlib.contextmanager
def locked(path, *, exclusive: bool):
    """Hold an advisory lock on ``<path>.lock`` for the duration of the
    block.  ``exclusive=True`` for writers (``LOCK_EX``), ``False`` for
    readers (``LOCK_SH``).  Never raises on lock failure — degrades to an
    unlocked critical section."""
    if fcntl is None:
        yield
        return
    lock_path = Path(str(path) + ".lock")
    fh = None
    try:
        fh = open(lock_path, "a+")
        fcntl.flock(fh.fileno(),
                    fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
    except OSError:
        if fh is not None:
            fh.close()
            fh = None
    try:
        yield
    finally:
        if fh is not None:
            try:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            fh.close()


def merge_save(path, merge_fn, *, indent=2, sort_keys: bool = False):
    """Atomically read-merge-write a shared JSON file.

    ``merge_fn(disk)`` receives the parsed on-disk document (``None`` when
    the file is missing or unreadable) and returns the document to write.
    The read, the merge and the write all happen under one exclusive
    advisory lock, so concurrent savers serialize and each one merges over
    the other's entries instead of clobbering them.  The write goes
    through :func:`replace_file` — a writer killed mid-save must leave
    the previous document intact, never a truncated file.  Returns
    whatever ``merge_fn`` returned."""
    p = Path(path)
    with locked(p, exclusive=True):
        try:
            disk = json.loads(p.read_text())
        except (OSError, ValueError):
            disk = None
        data = merge_fn(disk)
        replace_file(p, json.dumps(data, indent=indent,
                                   sort_keys=sort_keys))
    return data


def read_json(path, default=None):
    """Parse a shared JSON file under the shared advisory lock.  Missing,
    unreadable or corrupt files read as ``default`` — every shared file in
    this repo is merge-on-save, so a failed read is a cold start, never an
    error a reader should surface."""
    p = Path(path)
    with locked(p, exclusive=False):
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            return default


def replace_file(path, text: str) -> None:
    """Crash-safe whole-file replace: write a sibling temp file, then
    ``os.replace`` it over ``path`` (atomic on POSIX).  A process killed
    mid-write leaves at worst a stray ``<path>.tmp`` and the previous
    contents — never a torn/truncated shared file.  Callers that need
    mutual exclusion against concurrent replacers must hold the
    :func:`locked` exclusive lock around this (one shared temp name)."""
    p = Path(path)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, p)
