"""Device decision kernel (K3) parity vs the float64 host path."""

import numpy as np
import pytest

from duet_tpu.models import sv_phaser as svp
from duet_tpu.ops.phase_decide import phase_decide_packed

from test_sv_phaser import random_callset


@pytest.mark.parametrize("seed", range(12))
def test_device_kernel_matches_host(seed):
    rng = np.random.default_rng(1000 + seed)
    calls, records, read_hap = random_callset(rng, n_calls=60)
    svp.attach_read_haplotypes(records, read_hap)
    kept = [r for r in records
            if abs(r.svlen) >= 50 and r.support >= 2 and r.gt != "./."]
    if not kept:
        return
    packed = svp.pack_calls(kept)
    regime = svp.distinct_ps_regime(packed)
    oneps = svp.build_oneps_set(packed, np.ones(packed.n, bool), regime)
    if len(oneps) == 0:
        return
    feats = svp.compute_features(packed, regime, oneps)
    pred_host = svp.decide_haplotype(feats, regime)
    pred_dev, ps_dev = phase_decide_packed(packed, oneps)
    np.testing.assert_array_equal(pred_dev, pred_host)
    np.testing.assert_array_equal(ps_dev, feats.ps)


def test_threshold_edges_exact():
    """Pin the rational-threshold translations at exact boundary points."""
    from duet_tpu.io.vcf import SVRecord

    def mk(svread, refread, reads):
        rec = SVRecord(chrom="chr1", pos=1000, call_id="x", ref="N", alt="<DEL>",
                       qual=".", filt="PASS", info="", fmt="", sample="",
                       svlen=-100, svtype="DEL", support=svread,
                       read_names=[f"r{i}" for i in range(len(reads))],
                       gt="0/1", ref_reads=refread)
        rec.read_haps = reads
        return rec

    # sv_ratio == 0.72 boundary: 18/25 -> regime-2 rule fires (>=)
    cases = []
    # 18 sv / 7 ref = 0.72 exactly; two phase sets, avg diff 0 -> need sv_num>=3
    reads = [(1, 100, 50), (2, 100, 50), (1, 200, 50), (2, 200, 50)]
    cases.append((mk(18, 7, reads), 3))
    # 17.99.. below: 179 sv, 71 ref -> 179/250 = 0.716 < 0.72 -> no call
    cases.append((mk(179, 71, reads), 0))

    for rec, want in cases:
        packed = svp.pack_calls([rec])
        regime = svp.distinct_ps_regime(packed)
        # force anchors so both PS values qualify
        oneps = np.array([100, 200], dtype=np.int64)
        feats = svp.compute_features(packed, regime, oneps)
        host = svp.decide_haplotype(feats, regime)
        dev, _ = phase_decide_packed(packed, oneps)
        assert host[0] == dev[0] == want


def test_near_threshold_host_device_parity():
    """Adversarial boundary inputs for the float64-host vs exact-int-device
    agreement: hap_avgsc_diff landing exactly on 1369.50 (regime 2) and
    2400 (regime 1 gate), totsc_ratio exactly on 9.72 — plus one-unit
    perturbations on each side.  The auto gate routes big callsets to the
    device, so any latent divergence here would silently flip production
    outputs."""
    from duet_tpu.io.vcf import SVRecord

    def mk(svread, refread, reads, n_names=None):
        names = [f"r{i}" for i in range(n_names or len(reads))]
        rec = SVRecord(chrom="chr1", pos=1000, call_id="x", ref="N",
                       alt="<DEL>", qual=".", filt="PASS", info="", fmt="",
                       sample="", svlen=-100, svtype="DEL", support=svread,
                       read_names=names, gt="0/1", ref_reads=refread)
        rec.read_haps = reads + [None] * (len(names) - len(reads))
        return rec

    cases = []
    # regime 2, hap_avgsc_diff == 1369.50 exactly:
    # selected PS=100: hap1 avg 1000 (1 read), hap2 avg 2369.5 (4739/2)
    # -> diff 1369.5 <= 1369.50 -> sv_num>=3 -> pred 3
    r2_reads = [(1, 100, 1000), (2, 100, 2369), (2, 100, 2370),
                (1, 200, 50)]
    cases.append((mk(18, 7, r2_reads), np.array([100, 200]), 3))
    # one unit above: 4741/2 = 2370.5 -> diff 1370.5 > 1369.50
    # -> hap0>=6 branch; hap0 = 4 - 3 = 1 -> pred 0
    r2_above = [(1, 100, 1000), (2, 100, 2370), (2, 100, 2371),
                (1, 200, 50)]
    cases.append((mk(18, 7, r2_above), np.array([100, 200]), 0))

    # regime 1 one-hap gate, hap_avgsc_diff == 2400 exactly: one hap1 read
    # pc=2400, hapread_ratio 1/4 <= 0.75, sv_ratio 0.5 -> pred side 1
    cases.append((mk(5, 5, [(1, 100, 2400)], n_names=4),
                  np.array([100]), 1))
    # 2401: gate fails -> pred 0
    cases.append((mk(5, 5, [(1, 100, 2401)], n_names=4),
                  np.array([100]), 0))

    # regime 1 both-hap, totsc_ratio == 9.72 exactly (972/100),
    # sv_ratio 0.6 in band3 -> ratio <= 9.72 -> pred 3
    cases.append((mk(6, 4, [(1, 100, 972), (2, 100, 100)]),
                  np.array([100]), 3))
    # 973/100 = 9.73 > 9.72 -> larger-totsc side (hap1) -> pred 1
    cases.append((mk(6, 4, [(1, 100, 973), (2, 100, 100)]),
                  np.array([100]), 1))

    for rec, oneps, want in cases:
        packed = svp.pack_calls([rec])
        regime = svp.distinct_ps_regime(packed)
        oneps = oneps.astype(np.int64)
        feats = svp.compute_features(packed, regime, oneps)
        host = svp.decide_haplotype(feats, regime)
        dev, ps_dev = phase_decide_packed(packed, oneps)
        assert host[0] == dev[0] == want, (
            f"host={host[0]} dev={dev[0]} want={want} for {rec.read_haps}")
        assert ps_dev[0] == feats.ps[0]
