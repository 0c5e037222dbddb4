"""Neural pileup SNP caller (models/nn_snp.py) — the MXU analogue of the
reference's Clair3 pileup network (reference src/duet/snp_calling.py:13-17):
feature extraction, jax/numpy forward parity, held-out calling quality, and
the --snp-model nn pipeline path."""

import os

import numpy as np
import pytest

from duet_tpu.models import nn_snp
from duet_tpu.models.snp_caller import (
    SnpCallConfig,
    call_snps,
    count_alleles,
    pileup_observations,
)


def _pileup(sim_dataset):
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store

    out, _, truth = sim_dataset
    store = load_read_store(os.path.join(out, "reads.bam"))
    codes = FastaFile(os.path.join(out, "ref.fa")).fetch_codes("chr21")
    cfg = SnpCallConfig()
    obs = pileup_observations(store.contigs["chr21"], cfg)
    counts = count_alleles(obs[0], obs[1], obs[2], len(codes),
                           cfg.min_base_qual)
    return counts, codes, truth


def test_feature_shapes_and_ranges():
    rng = np.random.default_rng(0)
    L = 500
    counts = rng.integers(0, 30, size=(L, 4)).astype(np.int32)
    ref = rng.integers(0, 4, size=L).astype(np.uint8)
    pos = np.array([0, 3, 250, L - 1], dtype=np.int64)  # incl. both edges
    alt = rng.integers(0, 4, size=len(pos)).astype(np.uint8)
    x = nn_snp.extract_features(counts, ref, pos, alt)
    assert x.shape == (len(pos), nn_snp.N_FEATURES)
    assert x.dtype == np.float32
    assert np.isfinite(x).all()
    assert (x >= 0).all() and (x <= 1.0 + 1e-6).all()
    # empty candidate set is shape-safe
    empty = nn_snp.extract_features(counts, ref,
                                    np.zeros(0, np.int64), np.zeros(0, np.uint8))
    assert empty.shape == (0, nn_snp.N_FEATURES)


def test_forward_parity_jax_vs_numpy():
    params = nn_snp.init_params(seed=3)
    x = np.random.default_rng(1).random((257, nn_snp.N_FEATURES),
                                        dtype=np.float32)
    ref_logits = nn_snp.apply_np(params, x)
    jax_logits = np.asarray(nn_snp.apply(params, x))
    np.testing.assert_allclose(jax_logits, ref_logits, rtol=1e-5, atol=1e-5)
    assert (jax_logits.argmax(axis=1) == ref_logits.argmax(axis=1)).all()


def test_shipped_weights_load_and_decide(sim_dataset):
    counts, codes, truth = _pileup(sim_dataset)
    snps_jax = nn_snp.nn_call_snps("chr21", counts, codes, use_jax=True)
    snps_np = nn_snp.nn_call_snps("chr21", counts, codes, use_jax=False)
    np.testing.assert_array_equal(snps_jax.pos, snps_np.pos)
    np.testing.assert_array_equal(snps_jax.is_het, snps_np.is_het)
    np.testing.assert_array_equal(snps_jax.alt_code, snps_np.alt_code)


def _site_f1(snps, truth):
    tp = truth.snp_pos["chr21"]
    ta = truth.snp_alt["chr21"]
    order = np.argsort(tp)
    tp, ta = tp[order], ta[order]
    j = np.searchsorted(tp, snps.pos)
    ok = j < len(tp)
    jc = np.minimum(j, len(tp) - 1)
    hit = ok & (tp[jc] == snps.pos) & (ta[jc] == snps.alt_code)
    prec = hit.sum() / max(len(snps.pos), 1)
    rec = hit.sum() / max(len(tp), 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def test_nn_quality_close_to_rule_caller(sim_dataset):
    """Held-out seed: the network must land in the rule caller's quality
    band (it was trained on different seeds)."""
    counts, codes, truth = _pileup(sim_dataset)
    rule = call_snps("chr21", counts, codes, SnpCallConfig())
    nn = nn_snp.nn_call_snps("chr21", counts, codes, use_jax=False)
    f1_rule = _site_f1(rule, truth)
    f1_nn = _site_f1(nn, truth)
    assert f1_nn >= 0.9, f"nn site F1 {f1_nn:.3f}"
    assert f1_nn >= f1_rule - 0.06, f"nn {f1_nn:.3f} vs rule {f1_rule:.3f}"


def test_pipeline_with_nn_snp_model(tmp_path):
    from duet_tpu.eval.evaluate import evaluate_files
    from duet_tpu.pipeline import PipelineConfig, run_pipeline
    from duet_tpu.sim import SimConfig, simulate_dataset

    simulate_dataset(str(tmp_path), SimConfig(
        contigs={"chr21": 120_000}, coverage=22.0, seed=9))
    out_vcf = run_pipeline(PipelineConfig(
        bam=str(tmp_path / "reads.bam"), reference=str(tmp_path / "ref.fa"),
        output=str(tmp_path / "out_nn"), use_device_kernel=False,
        snp_model="nn"))
    res = evaluate_files(out_vcf, str(tmp_path / "truth.vcf"))
    assert res.calling[2] >= 0.85, f"calling F1 {res.calling[2]}"
    assert res.phasing[2] >= 0.8, f"phasing F1 {res.phasing[2]}"


def test_training_labeler():
    pos = np.array([10, 20, 30, 40], dtype=np.int64)
    alt = np.array([1, 2, 3, 0], dtype=np.uint8)
    tpos = np.array([20, 30, 40], dtype=np.int64)
    talt = np.array([2, 1, 0], dtype=np.uint8)  # 30 mismatches alt
    tgt = np.array([[1, 0], [1, 1], [1, 1]], dtype=np.int8)
    y = nn_snp._label_candidates(pos, alt, tpos, talt, tgt)
    assert y.tolist() == [0, 1, 0, 2]


def test_auto_model_policy(tmp_path):
    """--snp-model auto picks per the measured envelope: counts on clean
    data, nn on high-error data at workable coverage, counts again when
    coverage is too thin for the network (README grid)."""
    from duet_tpu.models.snp_caller import choose_snp_model

    rng = np.random.default_rng(0)
    L = 50_000
    ref = rng.integers(0, 4, L).astype(np.uint8)

    def image(cov, err):
        counts = np.zeros((L, 4), np.int32)
        n_err = int(L * cov * err)
        n_ok = int(L * cov) - n_err
        ok_pos = rng.integers(0, L, n_ok)
        np.add.at(counts, (ok_pos, ref[ok_pos]), 1)
        err_pos = rng.integers(0, L, n_err)
        np.add.at(counts, (err_pos, (ref[err_pos] + rng.integers(1, 4, n_err)) % 4), 1)
        return counts

    assert choose_snp_model(image(15, 0.02), ref) == "counts"
    assert choose_snp_model(image(15, 0.05), ref) == "nn"
    assert choose_snp_model(image(5, 0.05), ref) == "counts"  # too thin
    assert choose_snp_model(np.zeros((L, 4), np.int32), ref) == "counts"

    # coverage over N-reference stretches has no substitution rate and must
    # not count as error: clean data + a deep N block stays "counts"
    ref_n = ref.copy()
    ref_n[: L // 10] = 4  # 10% of sampled rows are N reference
    counts_n = image(15, 0.02)
    counts_n[: L // 10, 0] = 15  # full-depth coverage over the N block
    assert choose_snp_model(counts_n, ref_n) == "counts"


def test_pipeline_auto_model_dispatch(tmp_path):
    """End-to-end: auto resolves to counts on a clean sim (recorded in the
    dispatch table) and outputs equal an explicit counts run."""
    from duet_tpu.pipeline import PipelineConfig, run_pipeline
    from duet_tpu.sim import SimConfig, simulate_dataset
    from duet_tpu.utils import dispatch

    simulate_dataset(str(tmp_path), SimConfig(
        contigs={"chr21": 100_000}, coverage=15.0, seed=4))
    base = dict(bam=str(tmp_path / "reads.bam"),
                reference=str(tmp_path / "ref.fa"), use_device_kernel=False)
    auto_vcf = run_pipeline(PipelineConfig(
        output=str(tmp_path / "o_auto"), snp_model="auto", **base))
    snap = dispatch.snapshot().get("snp_pileup", {})
    assert snap.get("host", 0) >= 1 and snap.get("nn", 0) == 0
    counts_vcf = run_pipeline(PipelineConfig(
        output=str(tmp_path / "o_counts"), snp_model="counts", **base))
    assert open(auto_vcf, "rb").read() == open(counts_vcf, "rb").read()


def test_forward_pins_highest_precision():
    """All three products of the jax forward carry Precision.HIGHEST, so a
    GPU cannot run them in TF32 and drift from apply_np."""
    import jax

    params = nn_snp.init_params(seed=0)
    x = np.zeros((8, nn_snp.N_FEATURES), np.float32)
    jaxpr = jax.make_jaxpr(nn_snp.apply)(params, x)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 3
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST), e.params


@pytest.mark.chip
def test_forward_parity_on_gpu(gpu):
    import jax

    params = nn_snp.load_params()
    x = np.random.default_rng(2).random((1 << 16, nn_snp.N_FEATURES),
                                        dtype=np.float32)
    got = np.asarray(jax.jit(nn_snp.apply)(params, jax.device_put(x, gpu)))
    want = nn_snp.apply_np(params, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got.argmax(axis=1) == want.argmax(axis=1)).all()
