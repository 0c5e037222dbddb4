"""Device pileup: allele counting + SNP site calling as one jitted pass.

The SNP-calling stage's hot loop (host path: models.snp_caller
count_alleles/call_snps) restated for a device: counting is a scatter-add of
(position, base) observations into an (L, 4) count image, and site calling
is elementwise — both fuse into a single XLA computation with no
data-dependent shapes.  The driver feeds fixed-size observation batches
(padded with base=4 sentinels, which drop out of the counts) so one
compiled program serves every contig.

The allele-frequency comparison `alt/depth >= min_af` is evaluated in
exact integer form (alt * af_den >= depth * af_num) on both paths.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("length",))
def pileup_counts(positions, bases, quals, length: int, min_base_qual):
    """(L, 4) int32 allele counts from flat observation arrays.

    Padding convention: base >= 4 (N) never counts, so pad slots with
    base=4.  quals below min_base_qual are dropped (host parity).
    bases/quals arrive uint8 (6 B/observation over the host->device link
    instead of 12); widening happens on device.

    Counting is a SCATTER-ADD histogram (_hist_counts).  Dropped
    observations key to the 4L sentinel bin, which is sliced away.
    Bit-identical to the host bincount: integer counting has one
    answer."""
    keep = (bases < 4) & (quals.astype(jnp.int32) >= min_base_qual)
    key = jnp.where(keep, positions * 4 + bases.astype(jnp.int32), length * 4)
    return _hist_counts(key, length)


def _hist_counts(key, length: int):
    """(length, 4) int32 histogram of `key` = pos*4 + base, with dropped
    observations keyed to the length*4 sentinel bin (sliced away).

    SCATTER-ADD, not sort+searchsorted: a searchsorted over the bin
    boundaries gathers log2(bins) scattered elements per boundary query,
    where the scatter touches each key once.  Integer counting has one
    answer, so the two forms are bit-identical.

    Negative keys (malformed caller input) are routed to the sentinel bin
    explicitly: JAX's wrap-around indexing would otherwise fold them into
    real (pos, base) cells, where the old sort form dropped them and the
    host bincount raises."""
    key = jnp.where(key < 0, length * 4, key)
    counts = jnp.zeros(length * 4 + 1, jnp.int32).at[key].add(1)
    return counts[: length * 4].reshape(length, 4)


def packed_window_body(ops4, payload_ref, *, total: int, length: int,
                       max_sites: int):
    """The packed-pileup computation on ONE coordinate window — shared by
    the single-device jit wrapper (pileup_call_packed) and the mesh
    shard_map body (parallel.shard_pileup), so the sharded path is the
    same math by construction."""
    return _packed_impl(ops4, payload_ref, total=total, length=length,
                        max_sites=max_sites)


@partial(jax.jit, static_argnames=("total", "length", "max_sites"))
def pileup_call_packed(ops4, payload_ref, *, total: int, length: int,
                       max_sites: int):
    """Fused device pileup from PACKED READS: expand the per-op match table
    to the per-base observation stream ON DEVICE, count, call sites, and
    compact the (sparse) called sites — one launch per contig-group
    window.

    This replaces shipping the expanded observation stream host->device
    (~6 B/observation plus a host-side 3x repeat/gather expansion).  Each
    buffer costs a host<->device round trip, so everything rides as TWO
    uploads and ONE readback:

      ops4        (4, K) int32   rows [ref_start, query_start (NIBBLE
                                 index), length] of the match-op table
                                 (~read-count-scale K); row 3's first 8
                                 slots carry the scalar params [n_real,
                                 unused, min_depth, af_num, af_den,
                                 hom_num, hom_den, min_alt]
      payload_ref (ns/2+L,) u8   first ns/2 bytes: 4-bit NIBBLES, one per
                                 read base — bits 0-2 the base code, bit
                                 3 the HOST-evaluated qual-pass predicate
                                 (qual >= min_base_qual).  The kernel
                                 only ever compares qual against the
                                 floor, so the predicate bit is exact for
                                 ANY min_base_qual and the payload is
                                 half the bytes of a qual+base byte
                                 stream.
                                 Last L bytes: reference codes with 4 =
                                 never-call padding

    Expansion is a scatter-mark + cumsum lane->op mapping plus gathers
    over a static `total` — the exact math of the host
    pileup_observations' grouped arange, so counting is bit-identical.
    Padding contract (host side): op rows padded so
    cumulative length covers `total` exactly (one tail op with q=0/ref=0
    absorbing the remainder, then zero-length ops); pad lanes are masked
    by `lane < n_real`.  Returns one flat int32 array
    [n_sites, site_idx*max_sites, alt_code*, is_het*, depth*, alt_count*]
    — O(max_sites) readback, never O(L)."""
    return _packed_impl(ops4, payload_ref, total=total, length=length,
                        max_sites=max_sites)


def _packed_impl(ops4, payload_ref, *, total: int, length: int,
                 max_sites: int):
    op_ref, op_q, op_len = ops4[0], ops4[1], ops4[2]
    params = ops4[3]
    n_real, min_depth = params[0], params[2]
    af_num, af_den, hom_num, hom_den, min_alt = (
        params[3], params[4], params[5], params[6], params[7])
    nb = payload_ref.shape[0] - length
    payload = payload_ref[:nb]
    ref_codes = payload_ref[nb:]
    # lane -> op mapping computed ONCE and CHEAPLY: mark each op's first
    # lane with a K-element scatter-add (duplicates from zero-length ops
    # stack; the out-of-bounds pad-op starts drop per XLA scatter
    # semantics), then a cumsum over the lanes yields the owning op id —
    # one small scatter and one cumsum, where a searchsorted would gather
    # log2(K) scattered elements per lane.
    cum = jnp.cumsum(op_len)
    lane = jnp.arange(total, dtype=jnp.int32)
    marks = jnp.zeros(total, jnp.int32).at[cum - op_len].add(1, mode="drop")
    seg = jnp.cumsum(marks) - 1
    within = lane - (cum[seg] - op_len[seg])
    pos = op_ref[seg] + within
    qidx = op_q[seg] + within
    byte = payload[qidx >> 1].astype(jnp.int32)
    nib = (byte >> ((qidx & 1) << 2)) & 0xF
    base = nib & 7
    keep = (base < 4) & ((nib >> 3) > 0) & (lane < n_real)
    key = jnp.where(keep, pos * 4 + base, length * 4)
    counts = _hist_counts(key, length)
    is_site, is_het, alt_code, depth, alt_count = call_sites(
        counts, ref_codes, min_depth, af_num, af_den, hom_num, hom_den,
        min_alt)
    n_sites = is_site.sum().astype(jnp.int32)
    (site_idx,) = jnp.nonzero(is_site, size=max_sites, fill_value=0)
    site_idx = site_idx.astype(jnp.int32)
    return jnp.concatenate([
        n_sites[None], site_idx, alt_code[site_idx],
        is_het[site_idx].astype(jnp.int32), depth[site_idx],
        alt_count[site_idx]])


@partial(jax.jit, static_argnames=())
def call_sites(counts, ref_codes, min_depth, af_num, af_den, hom_num, hom_den,
               min_alt):
    """Elementwise site calling over the count image.

    Returns (is_site, is_het, alt_code, depth, alt_count) — the boolean
    masks and per-site stats the host path derives (models.snp_caller
    call_snps), with allele-frequency cuts in exact integer arithmetic:
    af >= af_num/af_den  <=>  alt * af_den >= depth * af_num.
    """
    L = counts.shape[0]
    depth = counts.sum(axis=1)
    ref_safe = jnp.minimum(ref_codes, 3).astype(jnp.int32)
    idx = jnp.arange(L)
    nonref = counts.at[idx, ref_safe].set(-1)
    alt_code = jnp.argmax(nonref, axis=1).astype(jnp.int32)
    alt_count = counts[idx, alt_code]
    is_site = (
        (depth >= min_depth)
        & (alt_count * af_den >= depth * af_num)
        & (alt_count >= min_alt)
        & (ref_codes < 4)
        & (alt_code != ref_safe)
    )
    is_het = alt_count * hom_den < depth * hom_num
    return is_site, is_het & is_site, alt_code, depth, alt_count
