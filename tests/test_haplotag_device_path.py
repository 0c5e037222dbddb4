"""Device-windowed haplotag path parity with the sparse host path."""

import numpy as np
import pytest

from duet_tpu.models import snp_phaser as sp
from test_snp_phaser import diploid_matrix, matrix_from_dense


@pytest.mark.parametrize("seed,window,halo,batch", [
    (0, 32, 8, 16),   # many windows, reads span window edges -> halo exercised
    (1, 2048, 256, 16),  # one window
    (2, 32, 8, 2),    # batch smaller than the task count -> multiple launches
    (3, 64, 16, 1),   # degenerate batch: one chunk per call
])
def test_windowed_device_matches_host(seed, window, halo, batch):
    rng = np.random.default_rng(seed)
    D, haps = diploid_matrix(rng, n_reads=150, n_sites=90, span=12, err=0.05)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    phase = sp._power_refine(am, phase, block_id, sweeps=2)

    host = sp._haplotag(am, phase, block_id, block_ps)
    dev = sp._haplotag_device(am, phase, block_id, block_ps,
                              window=window, halo=halo, batch=batch,
                              mode="dense")
    for h, d, name in zip(host, dev, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_batched_dispatch_call_count():
    """The whole contig's chunks ride a bounded number of device calls:
    ceil(chunks / batch), not one call per chunk."""
    from duet_tpu.utils import dispatch

    rng = np.random.default_rng(11)
    D, _ = diploid_matrix(rng, n_reads=900, n_sites=120, span=10, err=0.05)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    dispatch.reset()
    sp._haplotag_device(am, phase, block_id, block_ps, window=16, halo=4,
                        batch=16, mode="dense")
    calls = dispatch.snapshot().get("haplotag", {}).get("device", 0)
    # 900 reads over ~8 windows -> >= 8 chunks, but batched into one launch
    assert calls == 1


def test_overfull_window_falls_back_to_host():
    """A window with more phase-set blocks than the fixed kernel block axis
    routes its reads to the host path — outputs stay equal either way."""
    n_pairs = sp.HAPLOTAG_B + 10
    rows, cols, alleles, weights = [], [], [], []
    for i in range(n_pairs):  # read i covers only sites (2i, 2i+1)
        rows += [i, i]
        cols += [2 * i, 2 * i + 1]
        alleles += [1, -1]
        weights += [30.0, 30.0]
    from duet_tpu.models.snp_phaser import AlleleMatrix

    am = AlleleMatrix(
        n_reads=n_pairs, n_sites=2 * n_pairs,
        site_pos=np.arange(2 * n_pairs, dtype=np.int64) * 100,
        row=np.array(rows, np.int32), col=np.array(cols, np.int32),
        allele=np.array(alleles, np.int8),
        weight=np.array(weights, np.float32))
    phase, block_id, block_ps = sp._initial_phase(am)
    assert len(block_ps) > sp.HAPLOTAG_B
    host = sp._haplotag(am, phase, block_id, block_ps)
    dev = sp._haplotag_device(am, phase, block_id, block_ps,
                              window=4096, halo=256, mode="dense")
    for h, d, name in zip(host, dev, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_phase_contig_device_flag(sim_dataset):
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store
    from duet_tpu.models.snp_caller import call_snps_for_store

    out, _, _ = sim_dataset
    store = load_read_store(f"{out}/reads.bam")
    fa = FastaFile(f"{out}/ref.fa")
    snps, _ = call_snps_for_store(store, {"chr21": fa.fetch_codes("chr21")})
    cr = store.contigs["chr21"]
    host = sp.phase_contig(cr, snps["chr21"], use_device=False)
    dev = sp.phase_contig(cr, snps["chr21"], use_device=True)
    np.testing.assert_array_equal(dev.read_hap, host.read_hap)
    np.testing.assert_array_equal(dev.read_ps, host.read_ps)
    np.testing.assert_array_equal(dev.read_pc, host.read_pc)


def test_sparse_power_refine_device_matches_host():
    from duet_tpu.ops.sparse_power import power_refine_device

    rng = np.random.default_rng(7)
    from test_snp_phaser import diploid_matrix, matrix_from_dense
    D, _ = diploid_matrix(rng, n_reads=200, n_sites=77, span=14, err=0.08)
    am = matrix_from_dense(D)
    phase0, block_id, _ = sp._initial_phase(am)
    host = sp._power_refine(am, phase0.copy(), block_id, sweeps=3)
    dev = power_refine_device(am, phase0.copy(), block_id, sweeps=3)
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("seed,err", [(0, 0.05), (5, 0.15), (9, 0.0)])
def test_sparse_device_scoring_matches_host(seed, err):
    """The COO segment-sum scorer (the production single-device route) is
    bit-equal to the sparse host path, multi-block structure included."""
    rng = np.random.default_rng(seed)
    D, _ = diploid_matrix(rng, n_reads=250, n_sites=120, span=9, err=err)
    # carve coverage gaps so several phase-set blocks form
    D[:, 40:42] = 0
    D[:, 80:81] = 0
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    phase = sp._power_refine(am, phase, block_id, sweeps=2)
    host = sp._haplotag(am, phase, block_id, block_ps)
    dev = sp._haplotag_device(am, phase, block_id, block_ps, mode="sparse")
    for h, d, name in zip(host, dev, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_sparse_device_single_call_and_overflow_fallback():
    """The whole contig scores in ONE device call; a read spanning more
    than SLOT_K phase-set blocks routes to the host fallback and outputs
    stay equal."""
    from duet_tpu.ops.sparse_power import SLOT_K
    from duet_tpu.utils import dispatch

    n_blocks = SLOT_K + 4
    rows, cols, alleles, weights = [], [], [], []
    rid = 0
    for b in range(n_blocks):          # per-block anchor reads (2 sites)
        for _ in range(3):
            for j in (2 * b, 2 * b + 1):
                rows.append(rid); cols.append(j)
                alleles.append(1 if j % 2 == 0 else -1); weights.append(30.0)
            rid += 1
    # one read with an observation in EVERY block (> SLOT_K span)
    for b in range(n_blocks):
        rows.append(rid); cols.append(2 * b)
        alleles.append(1); weights.append(20.0)
    rid += 1
    am = sp.AlleleMatrix(
        n_reads=rid, n_sites=2 * n_blocks,
        site_pos=np.arange(2 * n_blocks, dtype=np.int64) * 5000,
        row=np.array(rows, np.int32), col=np.array(cols, np.int32),
        allele=np.array(alleles, np.int8),
        weight=np.array(weights, np.float32))
    # hand-split block structure (multi-block reads only arise AFTER weak-
    # junction splitting — spanning reads join blocks at _initial_phase):
    # one block per site pair, so the wide read touches every block
    block_id = (np.arange(2 * n_blocks) // 2).astype(np.int32)
    block_ps = am.site_pos[::2] + 1
    phase = np.array([1, -1] * n_blocks, dtype=np.int8)
    host = sp._haplotag(am, phase, block_id, block_ps)
    dispatch.reset()
    dev = sp._haplotag_device(am, phase, block_id, block_ps, mode="sparse")
    assert dispatch.snapshot().get("haplotag", {}).get("device", 0) == 1
    for h, d, name in zip(host, dev, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_int32_exactness_guard_routes_to_host(monkeypatch):
    """Above the int32-exactness bound the device refine AND scorer both
    fall back to the float64 host twins (their global int32 cumsums wrap
    past ~53M entries); outputs equal the host-only run."""
    import duet_tpu.ops.sparse_power as spw
    from duet_tpu.utils import dispatch

    rng = np.random.default_rng(7)
    D, _ = diploid_matrix(rng, n_reads=80, n_sites=60, span=10, err=0.05)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)

    monkeypatch.setattr(spw, "INT32_EXACT_NNZ", len(am.row) - 1)
    # refine: the phase_contig-level guard must pick the host iteration
    # even with use_device=True (route the matrix in via build_allele_matrix
    # so the full phase_contig path runs)
    monkeypatch.setattr(sp, "build_allele_matrix",
                        lambda cr, snps, cfg, obs=None: am)
    dispatch.reset()
    result = sp.phase_contig(None, None, use_device=True)
    snap = dispatch.snapshot().get("phase_refine", {})
    assert snap.get("host", 0) >= 1 and snap.get("device", 0) == 0
    host_result = sp.phase_contig(None, None, use_device=False)
    np.testing.assert_array_equal(result.read_hap, host_result.read_hap)
    out_dev = sp._power_refine(am, phase, block_id, sweeps=2)

    # scorer: _haplotag_sparse_device's own guard
    dispatch.reset()
    got = sp._haplotag_sparse_device(am, out_dev, block_id, block_ps)
    want = sp._haplotag(am, out_dev, block_id, block_ps)
    snap = dispatch.snapshot().get("haplotag", {})
    assert snap.get("device", 0) == 0
    for g, w, name in zip(got, want, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_multi_contig_batched_scoring_matches_per_contig():
    """score_contigs_batched: several contigs' scoring in ONE launch is
    bit-identical to per-contig scoring, and pays ONE device dispatch."""
    from duet_tpu.utils import dispatch

    cores = {}
    expected = {}
    for k, seed in enumerate((5, 6, 7)):
        rng = np.random.default_rng(seed)
        D, _ = diploid_matrix(rng, n_reads=80 + 30 * k, n_sites=50 + 10 * k,
                              span=9, err=0.05)
        am = matrix_from_dense(D)
        phase, block_id, block_ps = sp._initial_phase(am)
        phase = sp._power_refine(am, phase, block_id, sweeps=2)
        cores[f"chr{k}"] = (am, phase, block_id, block_ps)
        expected[f"chr{k}"] = sp._haplotag(am, phase, block_id, block_ps)
    dispatch.reset()
    results = sp.score_contigs_batched(cores, use_device=True,
                                       device_min_nnz=0)
    calls = dispatch.snapshot().get("haplotag", {}).get("device", 0)
    assert calls == 1  # three contigs, one launch
    for c, (hap, ps, pc) in expected.items():
        np.testing.assert_array_equal(results[c].read_hap, hap, err_msg=c)
        np.testing.assert_array_equal(results[c].read_ps, ps, err_msg=c)
        np.testing.assert_array_equal(results[c].read_pc, pc, err_msg=c)


def test_batched_scoring_host_below_gate():
    """Below the combined-nnz gate the batch scores on the host (identical
    outputs), with zero device dispatch."""
    from duet_tpu.utils import dispatch

    rng = np.random.default_rng(8)
    D, _ = diploid_matrix(rng, n_reads=60, n_sites=40, span=8, err=0.05)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    cores = {"c": (am, phase, block_id, block_ps)}
    expected = sp._haplotag(am, phase, block_id, block_ps)
    dispatch.reset()
    results = sp.score_contigs_batched(cores, use_device=True,
                                       device_min_nnz=10**9)
    assert dispatch.snapshot().get("haplotag", {}).get("device", 0) == 0
    np.testing.assert_array_equal(results["c"].read_hap, expected[0])
    np.testing.assert_array_equal(results["c"].read_ps, expected[1])
    np.testing.assert_array_equal(results["c"].read_pc, expected[2])
