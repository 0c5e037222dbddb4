"""Coordinate-sharded SV-signature clustering over a device mesh.

The genomic analogue of sequence parallelism (SURVEY.md §2.4, §5.7): the
position-sorted signature array of one contig is split into contiguous
COORDINATE RANGES along the mesh's "sp" axis, one range per device.  Chain
linkage only ever looks at adjacent signatures, so the sole cross-device
dependency is each range's first element against its left neighbor's last —
a one-element halo exchanged with `jax.lax.ppermute`.  Segment ids
are then globalized with an exclusive scan of per-shard break counts
(all_gather of one scalar per device), and the per-cluster statistics run
through the SAME segment-reduction core as the single-device kernel
(duet_tpu.ops.cluster._segment_stats), so clusters that straddle a shard
edge are reduced exactly — no approximation at the seams.

This replaces the reference pipeline's only intra-stage parallelism for
clustering — per-chromosome process fan-out via GNU parallel (reference
snp_phasing.py:22-29; cuteSV's own threading) — with in-graph XLA
collectives on the device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from duet_tpu.ops.cluster import (
    _POS_PAD,
    _break_flags,
    _segment_stats,
)


def _global_segment_ids(p, l, v, linkage: int, max_dist, cmd_num, cmd_den,
                        axis: str):
    """Per-shard body: break flags with a one-element left halo, then
    globally consistent segment ids.  p/l/v are this shard's contiguous
    slice of the globally sorted arrays."""
    n_shards = jax.lax.axis_size(axis)
    my = jax.lax.axis_index(axis)

    # halo: last element of the left neighbor (shard i-1 -> shard i)
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    prev_p = jax.lax.ppermute(p[-1:], axis, perm)
    prev_l = jax.lax.ppermute(l[-1:], axis, perm)
    prev_v = jax.lax.ppermute(v[-1:], axis, perm)

    # B[j] = 1 iff sorted element j starts a new segment (B[0] == 0 globally)
    brk_in = _break_flags(p[:-1], l[:-1], v[:-1], p[1:], l[1:], v[1:],
                          linkage, max_dist, cmd_num, cmd_den)
    brk_first = jnp.where(
        my == 0,
        jnp.zeros(1, bool),
        _break_flags(prev_p, prev_l, prev_v, p[:1], l[:1], v[:1],
                     linkage, max_dist, cmd_num, cmd_den),
    )
    brk = jnp.concatenate([brk_first, brk_in]).astype(jnp.int32)

    # exclusive scan of per-shard break totals -> this shard's id offset
    totals = jax.lax.all_gather(jnp.sum(brk), axis)
    offset = jnp.sum(jnp.where(jnp.arange(n_shards) < my, totals, 0))
    return offset + jnp.cumsum(brk, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("mesh", "linkage", "axis"))
def _cluster_sharded_jit(mesh, pos, length, read_idx, valid, linkage: int,
                         max_dist, cmd_num, cmd_den, axis: str = "sp"):
    seg_fn = jax.shard_map(
        partial(_global_segment_ids, linkage=linkage, max_dist=max_dist,
                cmd_num=cmd_num, cmd_den=cmd_den, axis=axis),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    seg = seg_fn(pos, length, valid)
    # per-cluster stats: the shared segment-reduction core on the sharded
    # arrays — XLA inserts the gathers/scatters the sorts need
    return _segment_stats(pos, length, read_idx, valid, seg), seg


def cluster_sharded(mesh, pos, length, read_idx, linkage: int, max_dist: int,
                    cmd_num: int, cmd_den: int, axis: str = "sp",
                    pad_to: int | None = None):
    """Mesh-sharded clustering; same contract as ops.cluster.cluster_host:
    returns (call_pos, call_len, support, count, seg_of_input).

    Signatures are sorted by position host-side, padded to a shard-divisible
    power of two, and placed with a NamedSharding over `axis` so each device
    owns one contiguous coordinate range.
    """
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    n_shards = int(mesh.shape[axis])
    if pad_to is None:
        pad_to = max(1 << (k - 1).bit_length(), 8, 2 * n_shards)
    pad_to = -(-pad_to // n_shards) * n_shards
    order = np.argsort(np.asarray(pos), kind="stable")

    pp = np.full(pad_to, _POS_PAD, dtype=np.int32)
    ll = np.zeros(pad_to, dtype=np.int32)
    rr = np.full(pad_to, -1, dtype=np.int32)
    vv = np.zeros(pad_to, dtype=bool)
    pp[:k] = np.asarray(pos, np.int32)[order]
    ll[:k] = np.asarray(length, np.int32)[order]
    rr[:k] = np.asarray(read_idx, np.int32)[order]
    vv[:k] = True

    sh = NamedSharding(mesh, P(axis))
    dev = [jax.device_put(a, sh) for a in (pp, ll, rr, vv)]
    out, seg = _cluster_sharded_jit(
        mesh, *dev, linkage, jnp.int32(max_dist),
        jnp.int32(cmd_num), jnp.int32(cmd_den), axis=axis,
    )

    is_seg = np.asarray(out["is_seg"])
    sel = np.flatnonzero(is_seg)
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = np.asarray(seg)[:k]
    return (
        np.asarray(out["call_pos"])[sel],
        np.asarray(out["call_len"])[sel],
        np.asarray(out["support"])[sel],
        np.asarray(out["count"])[sel],
        seg_of_input,
    )
