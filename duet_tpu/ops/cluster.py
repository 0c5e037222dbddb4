"""K2 — SV-signature clustering as sort + segment reduction.

The device replacement for cuteSV/SVIM's signature clustering loops
(reference sv_calling.py:13-20 external callers; SURVEY.md X3/X5): given
position-sorted signatures of one SV type, clusters are runs delimited by
boundary flags, and every per-cluster statistic is a fixed-shape segment
reduction — no data-dependent shapes, so the whole thing jits.

  linkage 'gap'  : break when pos[i] - pos[i-1] > max_dist        (cuteSV)
  linkage 'span' : break when (|dpos| + |dlen|) / max(len) > c    (SVIM -c)

Per cluster: member count, distinct supporting reads, lower-median position
and length.  The numpy host path (`cluster_host`) and the jitted device
path (`cluster_device`) share this formulation statistic-for-statistic;
models.sv_caller consumes the host path, tests pin both equal.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

GAP = 0
SPAN = 1


# --------------------------------------------------------------------------
# host (numpy) path
# --------------------------------------------------------------------------

def cluster_host(pos, length, read_idx, linkage: int, max_dist: int,
                 cmd_num: int, cmd_den: int):
    """Vectorized clustering of position-sorted signatures.

    cmd_num/cmd_den express cluster_max_distance as a small rational
    (e.g. 0.9 -> 9/10); the span compare runs in float32 with the SAME
    IEEE operations on host and device, so the two paths agree bit-for-bit
    without risking integer-product overflow.
    Returns (call_pos, call_len, support, count, seg_id_per_signature).
    """
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    order = np.argsort(pos, kind="stable")
    p, l, r = pos[order], length[order], read_idx[order]
    if linkage == SPAN:
        dpos = np.abs(p[1:] - p[:-1])
        dlen = np.abs(l[1:] - l[:-1])
        denom = np.maximum(np.maximum(l[1:], l[:-1]), 1)
        # float32 on BOTH host and device paths: IEEE multiply gives
        # bit-identical comparisons (int32/int64 products could overflow)
        brk = (dpos + dlen).astype(np.float32) * np.float32(cmd_den) \
            > denom.astype(np.float32) * np.float32(cmd_num)
    else:
        brk = (p[1:] - p[:-1]) > max_dist
    seg = np.zeros(k, dtype=np.int64)
    seg[1:] = np.cumsum(brk)
    nseg = int(seg[-1]) + 1

    count = np.bincount(seg, minlength=nseg)
    start = np.zeros(nseg, dtype=np.int64)
    start[1:] = np.cumsum(count)[:-1]
    med = start + (count - 1) // 2
    call_pos = p[med]

    # lower-median length: sort lengths within segments
    lorder = np.lexsort((l, seg))
    l_sorted = l[lorder]
    call_len = l_sorted[med]

    # distinct supporting reads: first occurrence of (seg, read) pairs
    rorder = np.lexsort((r, seg))
    rs, rr = seg[rorder], r[rorder]
    first = np.ones(k, dtype=bool)
    first[1:] = (rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1])
    support = np.bincount(rs, weights=first, minlength=nseg).astype(np.int64)

    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg
    return call_pos, call_len, support, count.astype(np.int64), seg_of_input


# --------------------------------------------------------------------------
# device (JAX) path — fixed shapes, padded signatures
# --------------------------------------------------------------------------

_POS_PAD = np.int32(2**31 - 1)


def pad_signatures(pos, length, read_idx, pad_to: int):
    """Pad to a fixed size with +inf-position sentinels (they form trailing
    padding segments the caller drops via the valid mask)."""
    k = len(pos)
    if k > pad_to:
        raise ValueError(f"{k} signatures > pad_to={pad_to}")
    pp = np.full(pad_to, _POS_PAD, dtype=np.int32)
    ll = np.zeros(pad_to, dtype=np.int32)
    rr = np.full(pad_to, -1, dtype=np.int32)
    pp[:k] = pos
    ll[:k] = length
    rr[:k] = read_idx
    return pp, ll, rr, k


def _break_flags(p_prev, l_prev, v_prev, p_next, l_next, v_next,
                 linkage: int, max_dist, cmd_num, cmd_den):
    """Elementwise linkage test between consecutive sorted signatures; the
    one formulation every path (device, sharded, host transcription) shares."""
    dpos = p_next - p_prev
    if linkage == SPAN:
        dlen = jnp.abs(l_next - l_prev)
        denom = jnp.maximum(jnp.maximum(l_next, l_prev), 1)
        brk = (jnp.abs(dpos) + dlen).astype(jnp.float32) * jnp.float32(cmd_den) \
            > denom.astype(jnp.float32) * jnp.float32(cmd_num)
    else:
        brk = dpos > max_dist
    # padding slots break away from real segments
    return brk | (v_next != v_prev)


def _segment_stats(p, l, r, v, seg):
    """Per-cluster statistics from globally sorted signatures + segment ids:
    the segment-reduction core shared by the single-device and mesh-sharded
    paths (identical ops -> identical results).

    `seg` is NON-DECREASING (a cumsum of break flags over position-sorted
    signatures), so every per-cluster reduction is a searchsorted bin
    bound + cumsum difference (whether a scatter form is faster on the
    GPU is ROADMAP 1.4)."""
    k = p.shape[0]
    bounds = jnp.searchsorted(seg, jnp.arange(k + 1, dtype=seg.dtype))
    # padded slots carry v=0: count real members only, but member RANGES
    # come from the bounds (padding sorts into its own trailing segments)
    ones_cs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(v.astype(jnp.int32))])
    count = ones_cs[bounds[1:]] - ones_cs[bounds[:-1]]
    start = bounds[:-1]
    med = jnp.clip(start + (count - 1) // 2, 0, k - 1)
    call_pos = p[med]

    lorder = jnp.lexsort((l, seg))
    l_sorted = l[lorder]
    call_len = l_sorted[med]

    rorder = jnp.lexsort((r, seg))
    rs = seg[rorder]          # == seg: the lexsort's primary key is already
    rr = r[rorder]            # sorted, so segment ranges (bounds) transfer
    rv = v[rorder]
    firsts = jnp.ones(k, dtype=bool)
    firsts = firsts.at[1:].set((rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1]))
    sup_cs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum((firsts & rv).astype(jnp.int32))])
    support = sup_cs[bounds[1:]] - sup_cs[bounds[:-1]]

    is_real_seg = count > 0
    return {
        "call_pos": call_pos,
        "call_len": call_len,
        "support": support,
        "count": count,
        "is_seg": is_real_seg,
        "seg_of_sorted": seg,
    }


@partial(jax.jit, static_argnames=("linkage",))
def cluster_device(pos, length, read_idx, n_valid, linkage: int,
                   max_dist, cmd_num, cmd_den):
    """Jitted clustering over padded signature arrays.

    Returns per-signature-slot segment stats scattered to each segment's
    first slot: (call_pos, call_len, support, count, is_seg_start, seg_id).
    Slots beyond the real segments have is_seg_start False.
    """
    k = pos.shape[0]
    idx = jnp.arange(k)
    valid = idx < n_valid
    order = jnp.argsort(jnp.where(valid, pos, _POS_PAD), stable=True)
    p = pos[order]
    l = length[order]
    r = read_idx[order]
    v = valid[order]

    brk = _break_flags(p[:-1], l[:-1], v[:-1], p[1:], l[1:], v[1:],
                       linkage, max_dist, cmd_num, cmd_den)
    seg = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(brk, dtype=jnp.int32)])
    out = _segment_stats(p, l, r, v, seg)
    out["order"] = order
    return out


def cluster_host_multi(svtype, pos, length, read_idx, linkage: int,
                       md_by_type, cmd_num: int, cmd_den: int):
    """One clustering pass over ALL SV types at once: signatures sort by
    (type, position), a type change forces a segment break, and the gap
    threshold is looked up per type (md_by_type, indexed by type code).
    Returns (call_pos, call_len, support, count, seg_of_input, call_type)
    — identical per-type results to running cluster_host per type, in one
    pass (one device invocation on the jitted twin: 4x fewer host<->device
    round-trips on the production SV stage)."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e, e
    order = np.lexsort((pos, svtype))
    t = np.asarray(svtype)[order]
    p, l, r = pos[order], length[order], read_idx[order]
    md = np.asarray(md_by_type, dtype=np.int64)[t]
    if linkage == SPAN:
        dpos = np.abs(p[1:] - p[:-1])
        dlen = np.abs(l[1:] - l[:-1])
        denom = np.maximum(np.maximum(l[1:], l[:-1]), 1)
        brk = (dpos + dlen).astype(np.float32) * np.float32(cmd_den) \
            > denom.astype(np.float32) * np.float32(cmd_num)
    else:
        brk = (p[1:] - p[:-1]) > md[1:]
    brk = brk | (t[1:] != t[:-1])
    seg = np.zeros(k, dtype=np.int64)
    seg[1:] = np.cumsum(brk)
    nseg = int(seg[-1]) + 1

    count = np.bincount(seg, minlength=nseg)
    start = np.zeros(nseg, dtype=np.int64)
    start[1:] = np.cumsum(count)[:-1]
    med = start + (count - 1) // 2
    call_pos = p[med]
    call_type = t[med].astype(np.int64)

    lorder = np.lexsort((l, seg))
    call_len = l[lorder][med]

    rorder = np.lexsort((r, seg))
    rs, rr = seg[rorder], r[rorder]
    first = np.ones(k, dtype=bool)
    first[1:] = (rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1])
    support = np.bincount(rs, weights=first, minlength=nseg).astype(np.int64)

    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg
    return call_pos, call_len, support, count.astype(np.int64), \
        seg_of_input, call_type


@partial(jax.jit, static_argnames=("linkage",))
def cluster_device_multi(svtype, pos, length, read_idx, valid,
                         linkage: int, md_by_type, cmd_num, cmd_den):
    """Jitted multi-type clustering over PRE-SORTED padded arrays (the
    device twin of cluster_host_multi): one invocation covers every SV type
    of a contig.  Inputs arrive sorted by (type, position) with padding at
    the tail — the wrapper sorts host-side (the arrays are already on the
    host, and an in-graph multi-key sort would add a compiled shape); the
    kernel keeps the
    break flags, segment-id scan, and segment reductions.
    md_by_type is a small int32 vector indexed by type code."""
    k = pos.shape[0]
    t = svtype
    md = md_by_type[jnp.clip(t, 0, md_by_type.shape[0] - 1)]
    brk = _break_flags(pos[:-1], length[:-1], valid[:-1],
                       pos[1:], length[1:], valid[1:],
                       linkage, md[1:], cmd_num, cmd_den)
    brk = brk | (t[1:] != t[:-1])
    seg = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(brk, dtype=jnp.int32)])
    out = _segment_stats(pos, length, read_idx, valid, seg)
    count = out["count"]
    start = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(count)[:-1]])
    med = jnp.clip(start + (count - 1) // 2, 0, k - 1)
    out["call_type"] = t[med]
    return out


def cluster_multi(svtype, pos, length, read_idx, linkage: int, md_by_type,
                  cmd_num: int, cmd_den: int, device: bool = False,
                  pad_to: int | None = None):
    """Host/device dispatch for the one-pass multi-type clustering; same
    return contract as cluster_host_multi.  Device shapes are padded to a
    power of two with a 2048 floor so nearly every contig shares one
    compiled program."""
    from duet_tpu.utils import devcost, dispatch

    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e, e
    if not device:
        dispatch.record("sv_cluster", "host")
        return cluster_host_multi(svtype, pos, length, read_idx, linkage,
                                  md_by_type, cmd_num, cmd_den)
    dispatch.record("sv_cluster", "device")
    if pad_to is None:
        pad_to = max(1 << (k - 1).bit_length(), 2048)
    order = np.lexsort((pos, svtype))
    pp, ll, rr, n = pad_signatures(np.asarray(pos, np.int32)[order],
                                   np.asarray(length, np.int32)[order],
                                   np.asarray(read_idx, np.int32)[order],
                                   pad_to)
    tt = np.full(pad_to, 127, dtype=np.int32)
    tt[:k] = np.asarray(svtype)[order]
    vv = np.zeros(pad_to, dtype=bool)
    vv[:k] = True
    dev = devcost.put("sv_cluster", tt, pp, ll, rr, vv,
                      np.asarray(md_by_type, np.int32))
    out = devcost.run(
        "sv_cluster", lambda: cluster_device_multi(
            dev[0], dev[1], dev[2], dev[3], dev[4], linkage, dev[5],
            jnp.int32(cmd_num), jnp.int32(cmd_den)))
    is_seg = devcost.get("sv_cluster", out["is_seg"])
    sel = np.flatnonzero(is_seg)
    seg_sorted = devcost.get("sv_cluster", out["seg_of_sorted"])
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg_sorted[:k]
    return (
        devcost.get("sv_cluster", out["call_pos"])[sel],
        devcost.get("sv_cluster", out["call_len"])[sel],
        devcost.get("sv_cluster", out["support"])[sel],
        devcost.get("sv_cluster", out["count"])[sel],
        seg_of_input,
        devcost.get("sv_cluster", out["call_type"])[sel],
    )


def cluster_device_to_host(pos, length, read_idx, linkage: int, max_dist: int,
                           cmd_num: int, cmd_den: int, pad_to: int | None = None):
    """Convenience wrapper: pad, run the device kernel, unpad, and return the
    same tuple as cluster_host (parity surface for tests and the caller)."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    if pad_to is None:
        pad_to = max(1 << (k - 1).bit_length(), 8)
    pp, ll, rr, n = pad_signatures(np.asarray(pos, np.int32),
                                   np.asarray(length, np.int32),
                                   np.asarray(read_idx, np.int32), pad_to)
    out = cluster_device(jnp.asarray(pp), jnp.asarray(ll), jnp.asarray(rr),
                         n, linkage, max_dist, cmd_num, cmd_den)
    is_seg = np.asarray(out["is_seg"])
    nseg = int(is_seg.sum())
    sel = np.flatnonzero(is_seg)[:nseg]
    seg_sorted = np.asarray(out["seg_of_sorted"])
    order = np.asarray(out["order"])
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order[:k]] = seg_sorted[:k]
    return (
        np.asarray(out["call_pos"])[sel],
        np.asarray(out["call_len"])[sel],
        np.asarray(out["support"])[sel],
        np.asarray(out["count"])[sel],
        seg_of_input,
    )
