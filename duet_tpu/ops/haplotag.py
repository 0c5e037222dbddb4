"""K1 — device haplotag scoring + phasing power iteration.

The device replacement for WhatsHap's per-read haplotype assignment
(reference snp_phasing.py:27-29): reads and phased het sites of a genomic
window form a dense (R x S) signed allele matrix A (+1 read shows alt,
-1 shows ref, 0 not covered), quality-weighted.  Everything the stage needs
is then matmuls:

  read scores   signed = (A*W) @ phase        (R,S)@(S,)  -> hap = sign
                total  = |A*W| @ |phase|                  -> PC from margin
  site update   votes  = (A*W)^T @ hap        (S,R)@(R,)  -> phase = sign
  block choice  blockw = |A*W| @ onehot(block) (R,S)@(S,B) -> argmax

One fused jitted step performs `sweeps` phase power-iteration rounds
followed by final read scoring; all matmuls run in bfloat16 with float32
accumulation (weights <= 40 and |A| <= 1 are exactly representable).

The host sparse path (duet_tpu.models.snp_phaser._power_refine/_haplotag)
computes the same quantities COO-style; parity is tested in
tests/test_haplotag_kernel.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PC_PER_MARGIN = 10
PC_MAX = 8100


def densify_window(am, site_lo: int, site_hi: int, read_ids: np.ndarray):
    """Slice an AlleleMatrix (COO) into dense (R, S) blocks for the kernel.

    Returns (alleles int8, weights float32) for the given site range and
    read subset. Rows follow read_ids order."""
    S = site_hi - site_lo
    R = len(read_ids)
    pos_of = {int(r): k for k, r in enumerate(read_ids)}
    A = np.zeros((R, S), dtype=np.int8)
    W = np.zeros((R, S), dtype=np.float32)
    sel = (am.col >= site_lo) & (am.col < site_hi)
    for r, c, a, w in zip(am.row[sel], am.col[sel], am.allele[sel], am.weight[sel]):
        k = pos_of.get(int(r))
        if k is not None:
            A[k, c - site_lo] = a
            W[k, c - site_lo] = w
    return A, W


@partial(jax.jit, static_argnames=("sweeps",))
def phase_and_tag(alleles, weights, phase0, block_onehot, sweeps: int = 2):
    """Fused phasing refinement + read haplotagging over one dense window.

    alleles      (R, S) int8   +1/-1/0
    weights      (R, S) float32
    phase0       (S,)  float32  initial site phases (+1/-1, 0 unphased)
    block_onehot (S, B) float32 site -> phase-set block membership
    sweeps       static number of power-iteration refinement rounds

    Returns dict with per-read hap (0 untagged / 1 / 2), pc, best_block,
    and per-site refined phase.
    """
    aw = (alleles.astype(jnp.bfloat16)) * weights.astype(jnp.bfloat16)
    abs_aw = jnp.abs(aw)
    covered = phase0 != 0  # sites eligible for phasing

    phase = phase0.astype(jnp.bfloat16)

    def sweep(phase, _):
        signed = jax.lax.dot_general(
            aw, phase[:, None], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0]
        h = jnp.sign(signed).astype(jnp.bfloat16)
        votes = jax.lax.dot_general(
            aw.T, h[:, None], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0]
        new_phase = jnp.where(votes > 0, 1.0, jnp.where(votes < 0, -1.0, phase))
        return jnp.where(covered, new_phase, 0.0).astype(jnp.bfloat16), None

    phase, _ = jax.lax.scan(sweep, phase, None, length=sweeps)

    # final scoring: one matmul computes [signed, total, per-block weight]
    informative = (phase != 0).astype(jnp.bfloat16)
    rhs = jnp.concatenate(
        [phase[:, None], informative[:, None],
         block_onehot.astype(jnp.bfloat16)], axis=1,
    )
    # signed uses aw; total and block weights use |aw|
    out_signed = jax.lax.dot_general(
        aw, rhs[:, :1], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )[:, 0]
    out_rest = jax.lax.dot_general(
        abs_aw, rhs[:, 1:], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    total = out_rest[:, 0]
    blockw = out_rest[:, 1:]

    tagged = (total > 0) & (out_signed != 0)
    hap = jnp.where(tagged, jnp.where(out_signed > 0, 1, 2), 0).astype(jnp.int32)
    margin = jnp.abs(out_signed)
    pc = jnp.clip(jnp.rint(PC_PER_MARGIN * margin), 1, PC_MAX).astype(jnp.int32)
    pc = jnp.where(tagged, pc, -1)
    best_block = jnp.argmax(blockw, axis=1).astype(jnp.int32)
    return {
        "hap": hap, "pc": pc, "best_block": best_block,
        "signed": out_signed, "total": total,
        "phase": jnp.sign(phase).astype(jnp.int8),
    }


@partial(jax.jit, static_argnames=("n_tasks", "n_blocks"))
def phase_and_tag_batch(alleles, weights, rhs, n_tasks: int, n_blocks: int):
    """`n_tasks` stacked (R, S) scoring chunks (phase_and_tag's final
    scoring, sweeps=0) in one jitted call: a batched dot_general with
    bf16 operands and f32 accumulation, so results equal phase_and_tag's
    task by task (every product is an exact small integer).

    alleles (n_tasks*R, S) int8; weights same shape (any float, cast to
    bf16); rhs (n_tasks*S, K) float — per-task [phase | informative |
    block-onehot] stacked on the site axis.
    Returns (hap, pc, best_block), each (n_tasks*R,) int32.
    """
    R = alleles.shape[0] // n_tasks
    S = alleles.shape[1]
    aw = (alleles.astype(jnp.bfloat16)
          * weights.astype(jnp.bfloat16)).reshape(n_tasks, R, S)
    rhs3 = rhs.astype(jnp.bfloat16).reshape(n_tasks, S, -1)
    batch_dot = (((2,), (1,)), ((0,), (0,)))
    signed = jax.lax.dot_general(
        aw, rhs3[:, :, :1], batch_dot, preferred_element_type=jnp.float32,
    )[..., 0]
    rest = jax.lax.dot_general(
        jnp.abs(aw), rhs3[:, :, 1:], batch_dot,
        preferred_element_type=jnp.float32,
    )
    total = rest[..., 0]
    blockw = rest[..., 1:1 + n_blocks]

    tagged = (total > 0) & (signed != 0)
    hap = jnp.where(tagged, jnp.where(signed > 0, 1, 2), 0).astype(jnp.int32)
    pc = jnp.clip(jnp.rint(PC_PER_MARGIN * jnp.abs(signed)), 1, PC_MAX)
    pc = jnp.where(tagged, pc.astype(jnp.int32), -1)
    best = jnp.argmax(blockw, axis=2).astype(jnp.int32)  # XLA: first max wins
    return hap.reshape(-1), pc.reshape(-1), best.reshape(-1)


def block_onehot_from_ids(block_id: np.ndarray, n_blocks: int) -> np.ndarray:
    """(S, B) membership matrix; unassigned sites (block -1) map nowhere."""
    S = len(block_id)
    out = np.zeros((S, max(n_blocks, 1)), dtype=np.float32)
    ok = block_id >= 0
    out[np.arange(S)[ok], block_id[ok]] = 1.0
    return out
