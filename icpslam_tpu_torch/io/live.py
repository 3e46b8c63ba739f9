"""Live scan ingest: consume velodyne-format ``.bin`` files as they appear
in a directory (port of ``icpslam_tpu/io/live.py``; host code).

The transport-free analog of the reference's live sensor topic: a
producer (a sensor daemon, a bag bridge, another process) drops files into
a spool directory and the runner's ``--watch`` consumes them in
sensor-stamp order. Back-pressure is the filesystem.

Producer contract: name files ``<seconds>.bin`` (any digit count: the
consumer orders by the parsed stamp, not lexicographically) and write them
under a temporary name, then ``rename`` (atomic on POSIX). Non-atomic
writers are tolerated: a file is consumed only once its size is a whole
number of 16-byte records and the same across two polls. Files are
expected in stamp order; once the name bookkeeping has begun to evict, a
parseable-stamp file at or below the consumed watermark counts as
consumed and is not read again, which keeps the bookkeeping bounded on
missions whose producer never deletes. The stream ends on a ``STOP`` file
(after everything before it is drained) or after ``idle_timeout``
seconds with no file arriving or growing.

    python -m icpslam_tpu_torch.io.runner --watch /var/spool/scans
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional

from icpslam_tpu_torch.io import kitti, native_loader
from icpslam_tpu_torch.io.synthetic import pad
from icpslam_tpu_torch.utils.logging import Logger

STOP_FILE = "STOP"
_RECORD_BYTES = 16  # float32 x, y, z, reflectance
_SEEN_LIMIT = 8192  # bookkeeping bound for very long runs


def _stamp_of(path: str) -> float:
    """Sensor stamp: ``<seconds>.bin`` filename when parseable (the
    producer's timestamp), else file mtime."""
    base = os.path.splitext(os.path.basename(path))[0]
    try:
        return float(base)
    except ValueError:
        return os.path.getmtime(path)


def directory_stream(
    path: str,
    capacity: int,
    poll_interval: float = 0.05,
    idle_timeout: float = 30.0,
    with_stamps: bool = True,
    min_range: float = 2.5,
    max_range: float = 80.0,
    use_native: Optional[bool] = None,
    logger=None,
) -> Iterator:
    """Yield padded ``(points, mask)`` scans (or ``((points, mask), stamp)``
    pairs) from ``path`` as files arrive, ordered by parsed sensor stamp within each poll batch.
    Ends on a ``STOP`` file (after draining everything before it) or
    after ``idle_timeout`` seconds with no new files.
    """
    if use_native is None:
        use_native = native_loader.available()
    seen: Dict[str, None] = {}  # insertion-ordered; pruned at _SEEN_LIMIT
    sizes: Dict[str, int] = {}  # last observed size of not-yet-stable files
    # Highest consumed parseable filename stamp. Once eviction has begun,
    # a not-in-``seen`` ``.bin`` whose stamp is <= this is skipped: it is
    # indistinguishable from an already-consumed file whose name was
    # evicted, and with a producer that never deletes, consumed files
    # DOMINATE that set — per-file counting/warning would flood false
    # positives and reinstate unbounded bookkeeping. The first eviction
    # logs the cutoff once so the policy is visible. Before any eviction,
    # ``seen`` is complete, so a new name below the watermark is provably
    # a late out-of-order arrival and is ingested.
    watermark = float("-inf")
    n_evicted = 0
    if logger is None:
        logger = Logger(level=1)

    def _name_stamp(name: str) -> Optional[float]:
        try:
            return float(os.path.splitext(name)[0])
        except ValueError:
            return None

    last_new = time.monotonic()
    while True:
        stop = False
        candidates = []
        try:
            with os.scandir(path) as it:
                for e in it:
                    if e.name == STOP_FILE:
                        stop = True
                    elif e.name.endswith(".bin") and e.name not in seen:
                        s = _name_stamp(e.name)
                        if s is not None and s <= watermark and n_evicted:
                            continue  # see watermark policy comment above
                        candidates.append(e)
        except FileNotFoundError:
            pass
        # consume only size-stable, whole-record files (tolerates
        # non-atomic producers: cp / cross-filesystem mv expose the
        # destination name mid-copy)
        ready = []
        progress = False  # any file appeared, grew, or became ready
        for e in candidates:
            try:
                size = e.stat().st_size
            except OSError:
                continue
            if size % _RECORD_BYTES == 0 and sizes.get(e.name) == size:
                ready.append(e.name)
                sizes.pop(e.name, None)
                progress = True
            else:
                if sizes.get(e.name) != size:
                    progress = True
                sizes[e.name] = size
        # sort only the new batch, by parsed stamp (lexicographic order
        # breaks at digit-count boundaries: '100.0.bin' < '99.9.bin')
        ready.sort(key=lambda f: _stamp_of(os.path.join(path, f)))
        for f in ready:
            seen[f] = None
            s = _name_stamp(f)
            if s is not None and s > watermark:
                watermark = s
            if len(seen) > _SEEN_LIMIT:
                # Evict only names the watermark covers (parseable stamp
                # <= watermark): those can never be re-yielded. Names
                # without a parseable stamp must stay pinned — the name
                # set is their only duplicate guard.
                evicted_this_pass = 0
                for old in list(seen)[: _SEEN_LIMIT // 2]:
                    so = _name_stamp(old)
                    if so is not None and so <= watermark:
                        del seen[old]
                        evicted_this_pass += 1
                # announce the policy only when a pass actually deleted
                # entries (a pass can evict nothing — unparseable names,
                # stamps above the watermark — and must not spam the
                # notice; ADVICE r4)
                if evicted_this_pass and n_evicted == 0:
                    logger.info(
                        "live ingest: bookkeeping eviction active — "
                        f".bin names with stamp <= {watermark:.6f} (and "
                        "below the future consumed watermark) will not "
                        "be re-ingested; producers should delete or "
                        "stamp-order their files"
                    )
                n_evicted += evicted_this_pass
            full = os.path.join(path, f)
            if use_native:
                scan = native_loader.read_scan(
                    full, capacity, min_range=min_range, max_range=max_range
                )
            else:
                scan = pad(
                    kitti.read_scan(
                        full, max_points=capacity,
                        min_range=min_range, max_range=max_range,
                    ),
                    capacity,
                )
            last_new = time.monotonic()
            yield (scan, _stamp_of(full)) if with_stamps else scan
        if progress:
            # A file appeared, grew, or became ready: that's producer
            # activity — a single large file taking > idle_timeout to
            # write must defer the idle shutdown just like it defers STOP.
            last_new = time.monotonic()
        if stop and not progress:
            # STOP seen and nothing is still arriving/stabilizing —
            # drained (a stuck partial file cannot wedge the shutdown)
            return
        if not ready:
            if time.monotonic() - last_new > idle_timeout:
                return
            time.sleep(poll_interval)
