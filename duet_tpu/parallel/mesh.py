"""Device-mesh runtime: sharded phasing/haplotagging with XLA collectives.

The reference's only concurrency is GNU-parallel process fan-out over
chromosomes plus files-on-disk as the data plane (SURVEY.md §2.4, §5.8).
Here scaling is a first-class device-mesh design:

  mesh axes   ("dp", "sp")
  dp          data parallel over READ batches — each chip owns a row-slice
              of the (R x S) allele matrix
  sp          sequence parallel over SNP SITES (the genomic axis) — each
              chip owns a column-slice; site phases and block membership are
              sharded along it

  collectives  read scores  : psum over "sp"  (row matvec partials)
               site votes   : psum over "dp"  (column matvec partials)
  both ride the device interconnect; nothing touches the host between
  sweeps.

The per-shard math is identical to the single-chip kernel
(duet_tpu.ops.haplotag.phase_and_tag); tests pin sharded == single-device
output on a CPU-simulated 8-device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from duet_tpu.ops.haplotag import PC_MAX, PC_PER_MARGIN


def make_mesh(dp: int | None = None, sp: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a (dp, sp) mesh. With no arguments, all visible devices go to
    the data-parallel axis."""
    devs = np.array(devices if devices is not None else jax.devices())
    if dp is None:
        dp = len(devs) // sp
    if dp * sp != len(devs):
        devs = devs[: dp * sp]
    return Mesh(devs.reshape(dp, sp), ("dp", "sp"))


def pad_to_multiple(arr: np.ndarray, mult: int, axis: int) -> np.ndarray:
    """Zero-pad `axis` up to a multiple of `mult` (shard-divisibility)."""
    size = arr.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def _body(aw, abs_aw, phase, block_onehot, sweeps: int):
    """Per-shard computation; aw is the local (R/dp, S/sp) block."""
    covered = phase != 0

    def sweep(ph, _):
        signed = jax.lax.dot_general(
            aw, ph[:, None], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0]
        signed = jax.lax.psum(signed, "sp")
        h = jnp.sign(signed).astype(jnp.bfloat16)
        votes = jax.lax.dot_general(
            aw.T, h[:, None], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0]
        votes = jax.lax.psum(votes, "dp")
        new_ph = jnp.where(votes > 0, 1.0, jnp.where(votes < 0, -1.0, ph))
        return jnp.where(covered, new_ph, 0.0).astype(jnp.bfloat16), None

    phase, _ = jax.lax.scan(sweep, phase.astype(jnp.bfloat16), None, length=sweeps)

    informative = (phase != 0).astype(jnp.bfloat16)
    out_signed = jax.lax.psum(
        jax.lax.dot_general(
            aw, phase[:, None], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0],
        "sp",
    )
    rest = jax.lax.psum(
        jax.lax.dot_general(
            abs_aw,
            jnp.concatenate([informative[:, None],
                             block_onehot.astype(jnp.bfloat16)], axis=1),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ),
        "sp",
    )
    total = rest[:, 0]
    blockw = rest[:, 1:]
    tagged = (total > 0) & (out_signed != 0)
    hap = jnp.where(tagged, jnp.where(out_signed > 0, 1, 2), 0).astype(jnp.int32)
    pc = jnp.clip(jnp.rint(PC_PER_MARGIN * jnp.abs(out_signed)), 1, PC_MAX)
    pc = jnp.where(tagged, pc.astype(jnp.int32), -1)
    best_block = jnp.argmax(blockw, axis=1).astype(jnp.int32)
    return hap, pc, best_block, jnp.sign(phase).astype(jnp.int8)


def _local_body(a, w, ph, bo, sweeps: int):
    aw = a.astype(jnp.bfloat16) * w.astype(jnp.bfloat16)
    return _body(aw, jnp.abs(aw), ph, bo, sweeps)


@partial(jax.jit, static_argnames=("mesh", "sweeps"))
def _phase_and_tag_sharded_jit(mesh, alleles, weights, phase0, block_onehot,
                               sweeps: int):
    fn = jax.shard_map(
        partial(_local_body, sweeps=sweeps),
        mesh=mesh,
        in_specs=(P("dp", "sp"), P("dp", "sp"), P("sp"), P("sp", None)),
        out_specs=(P("dp"), P("dp"), P("dp"), P("sp")),
    )
    return fn(alleles, weights, phase0, block_onehot)


def phase_and_tag_sharded(mesh: Mesh, alleles, weights, phase0, block_onehot,
                          sweeps: int = 2):
    """Mesh-sharded equivalent of ops.haplotag.phase_and_tag.

    alleles/weights (R, S) with R divisible by mesh dp-size and S by sp-size
    (use pad_to_multiple); block_onehot (S, B) replicated over dp, sharded
    over sp on the site axis. Returns (hap, pc, best_block, phase).

    Bit-identical to the single-device kernel: every matmul accumulates
    integer-valued bf16 products in float32 (weights <= 40, row sums well
    under 2^24), so the psum partial-sum order cannot perturb results.
    The jit is cached on (mesh, sweeps, shapes) — one compile per shape
    family, not per call.
    """
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    R, S = alleles.shape
    if R % dp or S % sp:
        raise ValueError(f"shape {alleles.shape} not divisible by mesh {dp}x{sp}")
    return _phase_and_tag_sharded_jit(
        mesh, jnp.asarray(alleles), jnp.asarray(weights),
        jnp.asarray(phase0, jnp.float32), jnp.asarray(block_onehot), sweeps,
    )
