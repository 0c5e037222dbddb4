"""Device sparse phasing power iteration + scoring (COO segment sums).

The phasing refinement alternates
    read haps   h = sign(A @ phase)
    site phases phase = sign(A^T @ h)
over the sparse (reads x het-sites) allele matrix.  The COO form maps
directly onto `jax.ops.segment_sum` — two segment reductions per sweep,
fixed shapes via power-of-two padding, fully device-resident.

`haplotag_score_sparse` extends the same formulation to the final read
scoring (the dense windowed kernel in ops.haplotag computes the identical
quantities as matmuls).  Shipping the COO moves ~12 bytes per observation
across the host->device link instead of the ~860 bytes/obs the dense
(reads x sites) window inflation costs at production sparsity (~0.4%),
and the whole contig scores in ONE device call.  The per-read phase-set
choice (host: largest summed weight per (read, block), earliest block on
ties) uses the fact that phase-set blocks are INTERVALS of the position-
sorted site axis: a read's candidate blocks form the contiguous range
[min block, max block] over its observations, so per-read relative slots
(block - min_block, capped at SLOT_K) turn the choice into a fixed-width
segment reduction + first-max argmax; reads spanning > SLOT_K blocks
(pathological fragmentation) are flagged for the host fallback.

Exactness: entry values are integers (allele * quality <= 40); float32
segment sums of integers are exact far beyond any realistic per-read or
per-site count, so sign decisions match the float64 host path bit for bit
(pinned in tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pow2(x: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(x, 1) - 1).bit_length())


@partial(jax.jit, static_argnames=("sweeps", "n_reads", "n_sites"))
def _refine(row, col, av, phase0, covered, sweeps: int, n_reads: int,
            n_sites: int):
    """row/col padded with sentinel n_reads / n_sites (one junk segment).

    SCATTER-ADD segment sums: both per-sweep reductions are plain
    `.at[idx].add(vals)` into (n+1)-bin accumulators (the sentinel lands
    in the junk bin), with no sort.  Exactness: per-BIN int32 sums are
    bounded by a single read's/site's weighted degree (<= 40 x
    observations on that read/site)."""
    av32 = av.astype(jnp.int32)

    def sweep(phase, _):
        pi = phase.astype(jnp.int32)
        s = jnp.zeros(n_reads + 1, jnp.int32).at[row].add(av32 * pi[col])
        h = jnp.sign(s)
        v = jnp.zeros(n_sites + 1, jnp.int32).at[col].add(
            av32 * h[row])[:n_sites]
        new_phase = jnp.where(v > 0, 1.0, jnp.where(v < 0, -1.0, phase))
        return jnp.where(covered, new_phase, 0.0), None

    phase, _ = jax.lax.scan(sweep, phase0, None, length=sweeps)
    return phase


def power_refine_device(am, phase: np.ndarray, block_id: np.ndarray,
                        sweeps: int = 2) -> np.ndarray:
    """Drop-in device twin of models.snp_phaser._power_refine."""
    from duet_tpu.utils import devcost, dispatch

    nnz = len(am.row)
    if nnz == 0 or am.n_sites == 0:
        return phase
    dispatch.record("phase_refine", "device")
    n_reads = _pow2(am.n_reads)
    n_sites = _pow2(am.n_sites)
    nnz_pad = _pow2(nnz)
    row = np.full(nnz_pad, n_reads, dtype=np.int32)
    col = np.full(nnz_pad, n_sites, dtype=np.int32)
    av = np.zeros(nnz_pad, dtype=np.float32)
    row[:nnz] = am.row
    col[:nnz] = am.col
    av[:nnz] = am.allele.astype(np.float32) * am.weight
    phase_pad = np.zeros(n_sites, dtype=np.float32)
    phase_pad[:am.n_sites] = phase
    covered = np.zeros(n_sites, dtype=bool)
    covered[:am.n_sites] = block_id >= 0
    dev = devcost.put("phase_refine", row, col, av, phase_pad, covered)
    out = devcost.run("phase_refine",
                      lambda: _refine(*dev, sweeps, n_reads, n_sites))
    return np.sign(
        devcost.get("phase_refine", out)[:am.n_sites]).astype(np.int8)


SLOT_K = 8       # per-read relative block slots (reads spanning more fall back)
PC_PER_MARGIN = 10
PC_MAX = 8100
# Exactness does not depend on this constant (each int32 bin sums one
# read's/site's entries, bounded by 40 x that read's observation count);
# it is a BATCH-SIZE bound: it caps the nnz_pad device buffers of one
# launch and splits multi-contig scoring batches (models.snp_phaser) at a
# size whose memory/runtime is known-good
INT32_EXACT_NNZ = 40_000_000


@partial(jax.jit, static_argnames=("n_reads", "n_sites"))
def _score(row, col, av, phase, block_id, n_reads: int, n_sites: int):
    """Sparse scoring over one contig's COO (padded; sentinel row/col index
    the junk segment).  Returns per-read (hap, pc, best_block, overflow).

    SCATTER-ADD and sort-free: per-read sums are `.at[key].add(values)`
    scatters, and per-read first/last blocks come from scatter min/max.

    Arithmetic is EXACT: every product allele*quality*phase is an integer
    with |.| <= 40 and each accumulator bin only ever sums ONE read's (or
    one (read, slot)'s) entries, so int32 bins are exact to ~53M
    observations PER READ — far beyond any data."""
    pv = phase[col]                       # int32 in {-1, 0, +1}
    v = av * pv
    absav = jnp.abs(av)
    inf = absav * (pv != 0)
    blk = block_id[col]
    R1 = n_reads + 1                      # + the junk bin (sentinel rows)

    signed = jnp.zeros(R1, jnp.int32).at[row].add(v)
    total = jnp.zeros(R1, jnp.int32).at[row].add(inf)
    # blocks are intervals of the site axis, so a read's candidate blocks
    # are the contiguous [min, max] of its entries' blocks.  Block ids in
    # col are always >= 0 (covered sites; the "-1 never appears in col"
    # invariant b_lo/slot already rely on), so the max-scatter's -1
    # sentinel doubles as the has-entries mask — no separate count pass.
    big = jnp.int32(1 << 30)
    b_lo_raw = jnp.full(R1, big, jnp.int32).at[row].min(blk)
    b_hi = jnp.full(R1, -1, jnp.int32).at[row].max(blk)
    has = b_hi >= 0
    b_lo = jnp.where(has, b_lo_raw, 0)
    overflow = has & ((b_hi - b_lo) >= SLOT_K)

    # per-(read, slot) weight sums: one scatter into R1 x SLOT_K bins
    slot = jnp.clip(blk - b_lo[row], 0, SLOT_K - 1)
    key2 = row * SLOT_K + slot
    blockw = jnp.zeros(R1 * SLOT_K, jnp.int32).at[key2].add(
        absav).reshape(R1, SLOT_K)
    best_slot = jnp.argmax(blockw, axis=1)   # XLA: first max = earliest block
    best_block = b_lo + best_slot.astype(jnp.int32)

    tagged = (total > 0) & (signed != 0)
    hap = jnp.where(tagged, jnp.where(signed > 0, 1, 2), 0).astype(jnp.int32)
    pc = jnp.clip(PC_PER_MARGIN * jnp.abs(signed), 1, PC_MAX)
    pc = jnp.where(tagged, pc.astype(jnp.int32), -1)
    return hap, pc, best_block, overflow


def haplotag_score_sparse_multi(items):
    """ONE device launch scoring SEVERAL contigs' COO matrices at once.

    `items`: list of (am, phase, block_id) per contig.  Per-contig COO
    blocks concatenate with read/site/block offsets into one big sparse
    matrix — reads never straddle contigs, sites stay position-sorted
    within their contig, and phase-set blocks remain intervals of the
    concatenated site axis, so the single-contig kernel (_score) applies
    unchanged and the per-call device floor is paid once per BATCH instead
    of once per contig.

    Returns a list of (hap, pc, best_block, overflow) per item with
    best_block re-based to the item's own block table.  Raises ValueError
    past the int32-exactness bound — callers split batches below it."""
    from duet_tpu.utils import devcost, dispatch

    tot_nnz = sum(len(it[0].row) for it in items)
    if tot_nnz > INT32_EXACT_NNZ:
        raise ValueError(
            f"batched nnz {tot_nnz} exceeds the int32-exactness bound "
            f"{INT32_EXACT_NNZ}; split the batch")
    tot_reads = sum(it[0].n_reads for it in items)
    tot_sites = sum(it[0].n_sites for it in items)
    n_reads = _pow2(tot_reads)
    n_sites = _pow2(tot_sites)
    nnz_pad = _pow2(max(tot_nnz, 1))
    row = np.full(nnz_pad, n_reads, dtype=np.int32)
    col = np.full(nnz_pad, n_sites, dtype=np.int32)
    av = np.zeros(nnz_pad, dtype=np.int32)
    phase_pad = np.zeros(n_sites + 1, dtype=np.int32)
    blk_pad = np.zeros(n_sites + 1, dtype=np.int32)
    metas = []
    r_off = s_off = b_off = z = 0
    for am, phase, block_id in items:
        k = len(am.row)
        row[z:z + k] = am.row + r_off
        col[z:z + k] = am.col + s_off
        av[z:z + k] = am.allele.astype(np.int32) * am.weight.astype(np.int32)
        phase_pad[s_off:s_off + am.n_sites] = phase
        # block -1 (site with no observations) never appears in col, so the
        # offset shift only needs to be right for covered sites
        blk_pad[s_off:s_off + am.n_sites] = block_id + b_off
        metas.append((r_off, am.n_reads, b_off))
        r_off += am.n_reads
        s_off += am.n_sites
        b_off += int(block_id.max()) + 1 if len(block_id) else 0
        z += k
    dispatch.record("haplotag", "device")
    dev = devcost.put("haplotag", row, col, av, phase_pad, blk_pad)
    hap, pc, best, ovf = devcost.run(
        "haplotag", lambda: _score(*dev, n_reads, n_sites))
    hap = devcost.get("haplotag", hap)
    pc = devcost.get("haplotag", pc)
    best = devcost.get("haplotag", best)
    ovf = devcost.get("haplotag", ovf)
    return [
        (hap[r0:r0 + nr].astype(np.int8), pc[r0:r0 + nr],
         best[r0:r0 + nr] - b0, ovf[r0:r0 + nr])
        for r0, nr, b0 in metas
    ]


def haplotag_score_sparse(am, phase: np.ndarray, block_id: np.ndarray):
    """Device twin of models.snp_phaser._haplotag's scoring math on the COO.

    Returns (hap, pc, best_block, overflow) numpy arrays of length
    am.n_reads; `overflow` marks reads whose observations span more than
    SLOT_K phase-set blocks — score those on the host.  best_block indexes
    block_ps (caller maps to PS and applies `overflow`/`tagged`)."""
    from duet_tpu.utils import devcost, dispatch

    nnz = len(am.row)
    n_reads = _pow2(am.n_reads)
    n_sites = _pow2(am.n_sites)
    nnz_pad = _pow2(nnz)
    dispatch.record("haplotag", "device")
    row = np.full(nnz_pad, n_reads, dtype=np.int32)
    col = np.full(nnz_pad, n_sites, dtype=np.int32)
    av = np.zeros(nnz_pad, dtype=np.int32)
    row[:nnz] = am.row
    col[:nnz] = am.col
    # quality weights are integer-valued; int32 products keep every device
    # sum exact (see _score)
    av[:nnz] = am.allele.astype(np.int32) * am.weight.astype(np.int32)
    phase_pad = np.zeros(n_sites + 1, dtype=np.int32)
    phase_pad[:am.n_sites] = phase
    blk_pad = np.zeros(n_sites + 1, dtype=np.int32)
    blk_pad[:am.n_sites] = block_id
    dev = devcost.put("haplotag", row, col, av, phase_pad, blk_pad)
    hap, pc, best, overflow = devcost.run(
        "haplotag", lambda: _score(*dev, n_reads, n_sites))
    n = am.n_reads
    return (devcost.get("haplotag", hap)[:n].astype(np.int8),
            devcost.get("haplotag", pc)[:n],
            devcost.get("haplotag", best)[:n],
            devcost.get("haplotag", overflow)[:n])
