"""The dense K1 kernels (ops.haplotag.phase_and_tag / phase_and_tag_batch)
against a numpy integer oracle.  Every product is allele (+-1) times an
integer weight <= 40, so each f32 sum is an exact integer and the kernels
must equal the oracle exactly, on any backend."""

import numpy as np
import pytest

import __graft_entry__ as g
from duet_tpu.ops.haplotag import (
    PC_MAX,
    PC_PER_MARGIN,
    phase_and_tag,
    phase_and_tag_batch,
)


def oracle(alleles, weights, phase0, onehot, sweeps):
    """phase_and_tag in int64: (hap, pc, best_block, phase)."""
    aw = alleles.astype(np.int64) * weights.astype(np.int64)
    covered = phase0 != 0
    phase = np.sign(phase0).astype(np.int64)
    for _ in range(sweeps):
        h = np.sign(aw @ phase)
        votes = aw.T @ h
        phase = np.where(votes > 0, 1, np.where(votes < 0, -1, phase))
        phase = np.where(covered, phase, 0)
    signed = aw @ phase
    total = np.abs(aw) @ (phase != 0).astype(np.int64)
    blockw = np.abs(aw) @ onehot.astype(np.int64)
    tagged = (total > 0) & (signed != 0)
    hap = np.where(tagged, np.where(signed > 0, 1, 2), 0)
    pc = np.where(tagged, np.clip(PC_PER_MARGIN * np.abs(signed), 1, PC_MAX),
                  -1)
    return hap, pc, blockw.argmax(axis=1), phase


def assert_matches_oracle(out, want):
    hap, pc, best, phase = want
    np.testing.assert_array_equal(np.asarray(out["hap"]), hap)
    np.testing.assert_array_equal(np.asarray(out["pc"]), pc)
    np.testing.assert_array_equal(np.asarray(out["best_block"]), best)
    np.testing.assert_array_equal(np.asarray(out["phase"]), phase)


@pytest.mark.parametrize("R,S,B,sweeps", [
    (300, 256, 5, 0), (256, 128, 1, 0), (700, 512, 33, 0),
    (300, 200, 5, 2), (1024, 512, 16, 2), (257, 129, 3, 3), (512, 256, 8, 0),
])
def test_phase_and_tag_matches_oracle(R, S, B, sweeps):
    alleles, weights, phase0, onehot = g._example_batch(R=R, S=S, B=B, seed=R)
    out = phase_and_tag(alleles, weights, phase0, onehot, sweeps=sweeps)
    assert_matches_oracle(out, oracle(alleles, weights, phase0, onehot,
                                      sweeps))


def test_batch_matches_per_task_phase_and_tag():
    """The stacked launch the dense pipeline path uses equals phase_and_tag
    run task by task (sweeps=0, rhs = [phase | informative | onehot])."""
    import ml_dtypes

    T, R, S, B = 3, 256, 256, 126
    A = np.zeros((T * R, S), np.int8)
    W = np.zeros((T * R, S), np.float32)
    rhs = np.zeros((T * S, 2 + B), np.float32)
    want = []
    for k in range(T):
        a, w, ph, oh = g._example_batch(R=R, S=S, B=B, seed=10 + k)
        A[k * R:(k + 1) * R] = a
        W[k * R:(k + 1) * R] = w
        rhs[k * S:(k + 1) * S, 0] = ph
        rhs[k * S:(k + 1) * S, 1] = ph != 0
        rhs[k * S:(k + 1) * S, 2:] = oh
        want.append(phase_and_tag(a, w, ph, oh, sweeps=0))
    hap, pc, best = phase_and_tag_batch(
        A, W.astype(ml_dtypes.bfloat16), rhs.astype(ml_dtypes.bfloat16),
        n_tasks=T, n_blocks=B)
    for key, got in (("hap", hap), ("pc", pc), ("best_block", best)):
        np.testing.assert_array_equal(
            np.asarray(got), np.concatenate([np.asarray(w[key]) for w in want]),
            err_msg=key)


@pytest.mark.chip
def test_phase_and_tag_matches_oracle_on_gpu(gpu):
    import jax

    alleles, weights, phase0, onehot = g._example_batch(R=8192, S=2048, B=64,
                                                        seed=3)
    args = [jax.device_put(a, gpu) for a in (alleles, weights, phase0, onehot)]
    out = phase_and_tag(*args, sweeps=2)
    assert_matches_oracle(out, oracle(alleles, weights, phase0, onehot, 2))
