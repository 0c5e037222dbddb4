"""Multi-host runtime: jax.distributed wiring + read-batch sharding plan.

The reference scales across a single host with GNU-parallel process fan-out
and the filesystem as data plane (SURVEY.md §5.8).  Here multi-host scaling
is the standard JAX recipe:

  1. every host calls `init_distributed(...)` (coordinator address, process
     count, process id — or nothing under a supported cluster env, where
     jax.distributed auto-detects)
  2. `global_mesh(sp=...)` builds a (dp, sp) mesh over ALL devices of the
     job; within a host the collectives ride NVLink, across hosts the
     network
  3. each host ingests ITS OWN shard of read batches
     (`host_read_batches`), the phased-SNP index is replicated, and
     `phase_and_tag_sharded` runs under the global mesh — XLA inserts the
     psum collectives across hosts exactly as it does across chips
  4. per-shard results are host-local rows; the final VCF emission is
     single-writer on process 0 after an all_gather of the per-shard
     phased calls (`gather_rows`)

Single-host multi-chip uses the same code with init skipped; CPU tests
exercise it on a virtual 8-device mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from duet_tpu.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-host runtime (no-op when single-process).

    Under supported cluster environments jax.distributed auto-detects all
    arguments; pass them explicitly otherwise."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(sp: int = 1) -> Mesh:
    """(dp, sp) mesh over every device in the job (all hosts)."""
    n = len(jax.devices())
    if n % sp:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    return make_mesh(dp=n // sp, sp=sp)


def host_read_batches(n_reads: int, batch: int,
                      process_id: int | None = None,
                      num_processes: int | None = None):
    """Row ranges of the read axis owned by this host: contiguous
    round-robin batches so coordinate locality is preserved per batch."""
    pid = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if num_processes is None else num_processes
    out = []
    for start in range(pid * batch, n_reads, batch * np_):
        out.append((start, min(start + batch, n_reads)))
    return out


def gather_rows(mesh: Mesh, local_rows: np.ndarray) -> np.ndarray:
    """All-gather per-host row blocks (single-writer emission input).

    With one process this is the identity; multi-host it rides DCN via
    jax.experimental.multihost_utils."""
    if jax.process_count() == 1:
        return np.asarray(local_rows)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(local_rows, tiled=True)
    )
