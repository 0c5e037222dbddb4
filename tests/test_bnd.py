"""Breakend (BND) translocations: simulation, cross-contig detection,
mated VCF emission, opt-in phasing, streaming parity, and eval scoring.

The base callers the reference wraps (cuteSV/Sniffles/SVIM) all emit
SVTYPE=BND mate pairs; the reference parser passes them through
(read_file.py:25-77) and its phasing stage drops them at the SVLEN filter
(sv_phasing_fn.py:189).  The framework mirrors that default and adds
--phase-bnd to push breakends through the decision stage.
"""

import numpy as np
import pytest

from duet_tpu.eval.evaluate import evaluate_files, load_eval_vcf
from duet_tpu.io.readstore import load_read_store
from duet_tpu.models.sv_caller import SvCallConfig, call_bnds_for_store
from duet_tpu.pipeline import PipelineConfig, run_pipeline
from duet_tpu.sim import SimConfig, simulate_dataset


@pytest.fixture(scope="module")
def tra_demo(tmp_path_factory):
    d = tmp_path_factory.mktemp("tra")
    truth = simulate_dataset(str(d), SimConfig(
        contigs={"chrA": 150_000, "chrB": 150_000}, seed=3, coverage=20.0,
        tra_count=2,
    ))
    return d, truth


def test_bnd_detection_matches_truth(tra_demo):
    d, truth = tra_demo
    store = load_read_store(f"{d}/reads.bam")
    bnds = call_bnds_for_store(store, SvCallConfig())
    assert len(bnds) >= len(truth.tra)
    for ca, pa, cb, pb, gt in truth.tra:
        hit = [b for b in bnds
               if {(b.contig1, ), (b.contig2, )} == {(ca, ), (cb, )}
               and abs(b.pos1 - (pa if b.contig1 == ca else pb)) <= 100
               and abs(b.pos2 - (pb if b.contig2 == cb else pa)) <= 100]
        assert hit, f"junction {ca}:{pa}<->{cb}:{pb} not recovered"
        b = hit[0]
        want_het = int(gt.sum()) == 1
        assert (b.gt in ("0/1",)) == want_het


def test_bnd_vcf_mate_pairs(tra_demo, tmp_path):
    d, _ = tra_demo
    out = run_pipeline(PipelineConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
        output=str(tmp_path / "out"), use_device_kernel=False,
        include_all_ctgs=True,
    ))
    variants = str(tmp_path / "out" / "sv_calling" / "variants.vcf")
    lines = [ln for ln in open(variants) if "SVTYPE=BND" in ln]
    assert lines and len(lines) % 2 == 0, "breakends come as mate pairs"
    by_id = {}
    for ln in lines:
        cols = ln.split("\t")
        info = dict(kv.split("=", 1) for kv in cols[7].split(";") if "=" in kv)
        by_id[cols[2]] = (cols[0], int(cols[1]), cols[4], info)
    for rid, (chrom, pos, alt, info) in by_id.items():
        mate = by_id[info["MATEID"]]
        # the mate record points back at this record's locus
        assert mate[3]["MATEID"] == rid
        assert mate[3]["CHR2"] == chrom and int(mate[3]["END"]) == pos
        assert f"{chrom}:{pos}" in mate[2], "mate ALT encodes this breakend"
        assert ("[" in alt) or ("]" in alt)
    # default (reference-parity) phasing drops breakends
    assert "SVTYPE=<BND>" not in open(out).read()


def test_bnd_phasing_opt_in(tra_demo, tmp_path):
    d, truth = tra_demo
    out = run_pipeline(PipelineConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
        output=str(tmp_path / "out"), use_device_kernel=False,
        include_all_ctgs=True, phase_bnd=True,
    ))
    text = open(out).read()
    assert "SVTYPE=<BND>" in text
    phased = [e for e in load_eval_vcf(out, all_ctgs=True)
              if e.svtype == "BND"]
    assert phased
    # every simulated junction was het: phased breakends must carry het HPs
    assert all(e.gt in ("1|0", "0|1") for e in phased)
    res = evaluate_files(out, f"{d}/truth.vcf", all_ctgs=True)
    assert res.calling[2] >= 0.8, f"calling f1 {res.calling[2]}"


def test_bnd_streaming_parity(tra_demo, tmp_path):
    d, _ = tra_demo
    from duet_tpu.pipeline import run_pipeline_streaming

    cfg = dict(bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
               use_device_kernel=False, include_all_ctgs=True)
    run_pipeline(PipelineConfig(output=str(tmp_path / "full"), **cfg))
    run_pipeline_streaming(PipelineConfig(output=str(tmp_path / "str"), **cfg))
    full = [ln for ln in open(tmp_path / "full" / "sv_calling" / "variants.vcf")
            if "SVTYPE=BND" in ln]
    stream = [ln for ln in open(tmp_path / "str" / "sv_calling" / "variants.vcf")
              if "SVTYPE=BND" in ln]
    assert full == stream


def test_eval_scores_bnd_records(tra_demo):
    d, truth = tra_demo
    entries = load_eval_vcf(f"{d}/truth.vcf", all_ctgs=True)
    bnd = [e for e in entries if e.svtype == "BND"]
    assert len(bnd) == 2 * len(truth.tra), "both mates load, no size cut"


def test_per_type_breakdown_includes_bnd(tra_demo, tmp_path):
    """evaluate_files reports a per-SVTYPE accuracy table; with --phase-bnd
    the BND row carries calling AND phasing numbers (the framework
    extension over the reference's SVLEN drop)."""
    d, truth = tra_demo
    out = str(tmp_path / "o")
    run_pipeline(PipelineConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa", output=out,
        use_device_kernel=False, include_all_ctgs=True, phase_bnd=True))
    res = evaluate_files(f"{out}/phased_sv.vcf", f"{d}/truth.vcf",
                         all_ctgs=True)
    s = res.summary()
    assert "per_type" in s and "BND" in s["per_type"]
    bnd = s["per_type"]["BND"]
    assert bnd["truth"] == 2 * len(truth.tra)
    assert bnd["calling"]["f1"] >= 0.8
    # the simulated junctions include hets; their phases must score
    assert bnd["phasing"]["recall"] > 0 or bnd["truth"] == 0
    # per-type calling tps sum to the overall tally
    assert sum(v["truth"] for v in s["per_type"].values()) == s["truth_svs"]
