"""Per-stage device COST attribution: transfer vs compute vs readback.

`utils.dispatch` answers *what ran where*; this module answers *where the
seconds went*.  Every device call site splits its work into three timed
phases — host->device puts (`put`), the jitted computation (`run`), and
the device->host readback (`get`) — and the per-stage sums land in
metrics.json (`device_cost`) and the bench e2e blocks.

Why this exists: with the split recorded, a slow stage is attributable
on its face: h2d_s >> compute_s is transfer-bound; compute_s dominating
is a kernel cost to fix; many small dispatches with high per-call floors
show up as n_dispatch x latency.

Semantics
  put(stage, *arrays)  jax.device_put each array, block until resident,
                       charge wall seconds + nbytes to h2d.  Also tracks
                       the WORST single put (the per-operation latency).
  run(stage, fn)       call fn, block on all output leaves, charge wall
                       seconds to compute and count one dispatch.  When
                       inputs were staged with put(), this is pure
                       device-side time + dispatch overhead; any h2d XLA
                       still performs (e.g. scalars) is charged here.
  get(stage, x)        np.asarray(x) on a ready array: pure d2h seconds.

The explicit put() serializes transfer and compute (no overlap): the
attribution requires a barrier, so it costs whatever overlap XLA could
have scheduled.  Host-clock seconds of threads in the stage pool add up,
so a stage's sum can exceed its wall time (ROADMAP 3.6).  Thread-safe
(stage fan-out uses thread pools).
Reference analogue: the per-stage wall-clock in run_duet.log
(/root/reference/src/duet/duet:21-27) — this is that, one level deeper.
"""

from __future__ import annotations

import threading
import time

import numpy as np

_lock = threading.Lock()
_acc: dict[str, dict[str, float]] = {}

_FIELDS = ("h2d_bytes", "h2d_s", "worst_put_s", "n_puts", "compute_s",
           "n_dispatch", "d2h_bytes", "d2h_s")


def _bucket(stage: str) -> dict[str, float]:
    b = _acc.get(stage)
    if b is None:
        b = _acc[stage] = {k: 0.0 for k in _FIELDS}
    return b


def reset() -> None:
    """Fresh accounting window (one per pipeline run)."""
    with _lock:
        _acc.clear()


def put(stage: str, *arrays, sharding=None):
    """Stage host arrays onto the default device (or with an explicit
    `sharding` for mesh paths), timed; returns the device arrays in order
    (singleton input -> singleton output, still a tuple)."""
    import jax

    out = []
    for a in arrays:
        t0 = time.perf_counter()
        d = jax.device_put(a, sharding) if sharding is not None \
            else jax.device_put(a)
        jax.block_until_ready(d)
        dt = time.perf_counter() - t0
        with _lock:
            b = _bucket(stage)
            b["h2d_bytes"] += getattr(a, "nbytes", np.asarray(a).nbytes)
            b["h2d_s"] += dt
            b["n_puts"] += 1
            b["worst_put_s"] = max(b["worst_put_s"], dt)
        out.append(d)
    return tuple(out)


def run(stage: str, fn, *args, **kwargs):
    """Execute one jitted call to completion, charging wall seconds to
    compute_s and counting one dispatch."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(jax.tree.leaves(out))
    dt = time.perf_counter() - t0
    with _lock:
        b = _bucket(stage)
        b["compute_s"] += dt
        b["n_dispatch"] += 1
    return out


def get(stage: str, x) -> np.ndarray:
    """Read one (already computed) device array back, timed."""
    t0 = time.perf_counter()
    out = np.asarray(x)
    dt = time.perf_counter() - t0
    with _lock:
        b = _bucket(stage)
        b["d2h_bytes"] += out.nbytes
        b["d2h_s"] += dt
    return out


def snapshot() -> dict[str, dict[str, float]]:
    """stage -> rounded cost fields, only stages that dispatched/transferred.
    Byte and count fields are ints; seconds keep 4 decimals."""
    with _lock:
        items = {s: dict(b) for s, b in _acc.items()}
    out: dict[str, dict[str, float]] = {}
    for stage, b in items.items():
        if not any(b.values()):
            continue
        row: dict[str, float] = {}
        for k, v in b.items():
            row[k] = int(v) if k.endswith(("bytes", "puts", "dispatch")) \
                else round(v, 4)
        out[stage] = row
    return out
