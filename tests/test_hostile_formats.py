"""Hostile-format fixtures: what REAL tools emit and the simulator never
does.  Every BAM case is exercised against BOTH the
native C++ decoder and the Python reader (column parity + observation-
stream parity); the VCF cases exercise the caller-format dispatch the
reference defines (read_file.py:40-76) and the resume/phase-only surfaces.

Cases:
  1. CIGAR `=`/`X` ops instead of M
  2. CIGAR `P` (padding) op mid-read
  3. CIGAR `N` (reference skip) op
  4. Hard clips (`H`) at both ends
  5. Missing base qualities (SAM `*`, BAM 0xFF bytes)
  6. Supplementary-only read name (no primary alignment present)
  7. Zero-length record (seq `*`, empty cigar) among normal reads
  8. Clair3-style multi-sample pileup VCF (GT:GQ:DP:AF) on --resume
  9. cuteSV DR,DV comma-packing edge cases (missing values, RE= support,
     SVLEN=> form)
 10. variants.vcf with out-of-order contigs through --phase-only
"""

import os

import numpy as np
import pytest

from duet_tpu.io.bam import BamHeader, BamRead, BamWriter, write_bam_index
from duet_tpu.io.fasta import write_fasta
from duet_tpu.io.readstore import load_read_store
from duet_tpu.models.snp_caller import SnpCallConfig, pileup_observations

REF_LEN = 3000


def _codes(s: str) -> np.ndarray:
    return np.array(["ACGTN".index(c) for c in s], dtype=np.uint8)


def _mkread(name, pos, cigar, seq, qual=None, flag=0, mapq=60):
    cig = np.array([[op, ln] for ln, op in cigar], dtype=np.int32) \
        if cigar else np.zeros((0, 2), np.int32)
    seq_codes = _codes(seq)
    if qual is None:
        qual = np.full(len(seq_codes), 30, np.uint8)
    return BamRead(name, flag, 0, pos, mapq, cig, seq_codes,
                   np.asarray(qual, np.uint8), {})


def _write_bam(path, reads, ref_name="chrH", ref_len=REF_LEN):
    header = BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ref_name}\tLN:{ref_len}\n",
        [ref_name], [ref_len])
    with BamWriter(path, header) as w:
        for r in sorted(reads, key=lambda r: r.pos):
            w.write(r)
    write_bam_index(path)


def _both_stores(bam):
    """(python_store, native_store) with column parity asserted."""
    from duet_tpu.io.native_ingest import load_read_store_native

    py = load_read_store(bam)
    nat = load_read_store_native(bam)
    assert set(py.contigs) == set(nat.contigs)
    for c in py.contigs:
        a, b = py.contigs[c], nat.contigs[c]
        assert a.names == b.names
        for field in ("starts", "ends", "mapq", "supp", "cigar_off",
                      "cigar_ops", "cigar_lens", "seq_off", "seq", "qual"):
            np.testing.assert_array_equal(
                getattr(a, field), getattr(b, field), err_msg=f"{c}.{field}")
    return py, nat


def _obs_parity(cr):
    """Host observation stream vs the native pileup pass."""
    from duet_tpu.io.native_ingest import pileup_obs_native

    cfg = SnpCallConfig()
    host = pileup_observations(cr, cfg)
    nat, _ = pileup_obs_native(cr, cfg.min_mapq)
    for h, n, name in zip(host, nat, ("pos", "base", "qual", "read")):
        np.testing.assert_array_equal(np.asarray(h, np.int64),
                                      np.asarray(n, np.int64), err_msg=name)
    return host


CIG = {c: i for i, c in enumerate("MIDNSHP=X")}


def test_eq_x_ops_count_like_match(tmp_path):
    """`10=1X9=` pileups exactly like `20M` with the same bases."""
    bam = str(tmp_path / "a.bam")
    seq = "ACGTACGTACGTACGTACGT"
    r1 = _mkread("eqx", 100, [(10, CIG["="]), (1, CIG["X"]), (9, CIG["="])], seq)
    r2 = _mkread("m", 100, [(20, CIG["M"])], seq)
    _write_bam(bam, [r1, r2])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    pos, base, qual, read = obs
    # both reads produce identical (pos, base) streams
    a = sorted(zip(pos[read == 0], base[read == 0]))
    b = sorted(zip(pos[read == 1], base[read == 1]))
    assert a == b and len(a) == 20


def test_padding_op_consumes_nothing(tmp_path):
    bam = str(tmp_path / "p.bam")
    seq = "ACGTACGTAC"
    r = _mkread("pad", 50, [(5, CIG["M"]), (3, CIG["P"]), (5, CIG["M"])], seq)
    _write_bam(bam, [r])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    assert list(obs[0]) == list(range(50, 60))  # P advanced neither axis


def test_ref_skip_op_advances_reference(tmp_path):
    bam = str(tmp_path / "n.bam")
    seq = "ACGTACGTAC"
    r = _mkread("skip", 50, [(5, CIG["M"]), (100, CIG["N"]), (5, CIG["M"])], seq)
    _write_bam(bam, [r])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    assert list(obs[0]) == list(range(50, 55)) + list(range(155, 160))
    assert py.contigs["chrH"].ends[0] == 160


def test_hard_clips_both_ends(tmp_path):
    bam = str(tmp_path / "h.bam")
    seq = "ACGTACGTAC"  # hard-clipped bases are NOT in seq
    r = _mkread("hard", 70, [(12, CIG["H"]), (10, CIG["M"]), (7, CIG["H"])], seq)
    _write_bam(bam, [r])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    assert list(obs[0]) == list(range(70, 80))


def test_missing_quals_star(tmp_path):
    """SAM `*` qualities arrive as 0xFF bytes; both decoders agree and the
    pipeline treats them consistently (255 passes any min_base_qual)."""
    bam = str(tmp_path / "q.bam")
    seq = "ACGTACGTAC"
    r = _mkread("noq", 10, [(10, CIG["M"])], seq,
                qual=np.full(10, 0xFF, np.uint8))
    _write_bam(bam, [r])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    assert (obs[2] == 255).all()


def test_supplementary_only_name(tmp_path):
    """A name with ONLY a supplementary alignment must ingest (supp kept)
    and survive the SNP/phasing stages without a primary to group with."""
    bam = str(tmp_path / "s.bam")
    rng = np.random.default_rng(3)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, REF_LEN))
    reads = [_mkread("only_supp", 500, [(60, CIG["M"])], ref[500:560],
                     flag=0x800)]
    for k in range(8):
        reads.append(_mkread(f"n{k}", 400 + 10 * k, [(300, CIG["M"])],
                             ref[400 + 10 * k:700 + 10 * k]))
    _write_bam(bam, reads)
    py, nat = _both_stores(bam)
    cr = py.contigs["chrH"]
    assert cr.supp.sum() == 1 and "only_supp" in cr.names
    ref_path = str(tmp_path / "ref.fa")
    write_fasta(ref_path, {"chrH": ref})
    from duet_tpu.models.snp_caller import call_contig_snps
    from duet_tpu.models.snp_phaser import phase_contig

    codes = _codes(ref)
    snps, site_obs = call_contig_snps("chrH", cr, codes, SnpCallConfig())
    phase_contig(cr, snps, SnpCallConfig(), obs=site_obs)  # no crash


def test_zero_length_record_among_reads(tmp_path):
    """A record with empty seq and empty cigar (SAM `*`/`*`) decodes on
    both paths and contributes nothing to the pileup."""
    bam = str(tmp_path / "z.bam")
    r0 = _mkread("empty", 30, [], "")
    r1 = _mkread("full", 25, [(10, CIG["M"])], "ACGTACGTAC")
    _write_bam(bam, [r0, r1])
    py, _ = _both_stores(bam)
    obs = _obs_parity(py.contigs["chrH"])
    assert len(obs[0]) == 10 and (obs[3] == list(py.contigs["chrH"].names).index("full")).all()


def test_clair3_multisample_pileup_resume(tmp_path):
    """A Clair3-style pileup.vcf.gz with TWO sample columns resumes: the
    first sample column drives genotype/depth extraction."""
    import gzip

    from duet_tpu.models.snp_caller import read_pileup_vcf

    path = str(tmp_path / "pileup.vcf.gz")
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2",
        "chr1\t101\t.\tA\tG\t12\tPASS\t.\tGT:GQ:DP:AF\t0/1:12:20:0.45\t1/1:9:18:0.9",
        "chr1\t201\t.\tC\tT\t20\tPASS\t.\tGT:GQ:DP:AF\t1/1:20:30:0.97\t0/1:5:22:0.5",
        "chr1\t301\t.\tG\tA,C\t9\tPASS\t.\tGT:GQ:DP:AF\t1/2:9:16:0.5\t0/0:3:10:0.1",
    ]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    snps = read_pileup_vcf(path)
    s = snps["chr1"]
    assert list(s.pos) == [100, 200, 300]
    assert list(s.is_het) == [True, False, True]  # 1/2 multi-allelic = het
    assert s.depth[0] == 20 and s.alt_count[0] == round(0.45 * 20)


def test_cutesv_drdv_comma_edge_cases(tmp_path):
    """DR,DV comma-packing with missing values, RE= support and SVLEN=>
    parse per the reference's caller dispatch (read_file.py:40-76)."""
    from duet_tpu.io.vcf import parse_sv_vcf

    path = str(tmp_path / "variants.vcf")
    with open(path, "w") as f:
        f.write("\n".join([
            "##fileformat=VCFv4.2",
            '##contig=<ID=chr1,length=100000>',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
            # cuteSV layout, missing DR
            "chr1\t1000\tc1\tN\t<DEL>\t.\tPASS\tSVLEN=-120;SVTYPE=DEL;RE=4;"
            "RNAMES=r1,r2,r3,r4\tGT:DR:DV\t0/1:.:4",
            # sniffles comma-packed DR,DV with a dot
            "chr1\t2000\tc2\tN\t<INS>\t.\tPASS\tSVLEN=>200;SVTYPE=INS;SUPPORT=3;"
            "RNAMES=a,b,c\tGT:DV:DR\t./.:3:.",
            # absent SVLEN + SVIM-style comma-packed DR,DV in the LAST field
            "chr1\t3000\tc3\tN\t<DUP>\t.\tPASS\tSVTYPE=DUP;RE=2;READS=x,y\t"
            "GT:GQ:AD\t1/1:.:10,2",
            # comma-packed with missing halves
            "chr1\t4000\tc4\tN\t<DEL>\t.\tPASS\tSVLEN=-80;SVTYPE=DEL;RE=2;"
            "RNAMES=u,v\tGT:GQ:AD\t0/1:20:.,.",
            # junk in a middle count field (the reference would crash;
            # tolerated as 0 here)
            "chr1\t5000\tc5\tN\t<INS>\t.\tPASS\tSVLEN=70;SVTYPE=INS;RE=2;"
            "RNAMES=w,z\tGT:DR:DV\t0/1:3,1:2",
        ]) + "\n")
    per = parse_sv_vcf(path, include_all_ctgs=True)
    recs = per["1" if "1" in per else "chr1"]
    assert [r.support for r in recs] == [4, 3, 2, 2, 2]
    assert recs[0].read_names == ["r1", "r2", "r3", "r4"]
    assert recs[1].svlen == 200 and recs[2].svlen == 0
    assert recs[0].gt == "0/1" and recs[1].gt == "./."
    assert (recs[2].ref_reads, recs[2].var_reads) == (10, 2)
    assert (recs[3].ref_reads, recs[3].var_reads) == (0, 0)
    assert (recs[4].ref_reads, recs[4].var_reads) == (0, 2)


def test_phase_only_out_of_order_contigs(tmp_path):
    """variants.vcf with records in chr2-before-chr1 order phases through
    --phase-only and emits the reference's lexicographic chrom sort."""
    from duet_tpu.pipeline import PipelineConfig, run_phase_only

    out = tmp_path / "out"
    (out / "sv_calling").mkdir(parents=True)
    (out / "snp_phasing").mkdir()
    with open(out / "sv_calling" / "variants.vcf", "w") as f:
        f.write("\n".join([
            "##fileformat=VCFv4.2",
            '##contig=<ID=chr1,length=100000>',
            '##contig=<ID=chr2,length=100000>',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
            "chr2\t5000\tv1\tN\t<INS>\t.\tPASS\tSVLEN=100;SVTYPE=INS;RE=3;"
            "RNAMES=r1,r2,r3\tGT:DR:DV\t0/1:5:3",
            "chr1\t4000\tv2\tN\t<DEL>\t.\tPASS\tSVLEN=-90;SVTYPE=DEL;RE=3;"
            "RNAMES=q1,q2,q3\tGT:DR:DV\t0/1:5:3",
        ]) + "\n")
    for chrom, names in (("chr1", "q"), ("chr2", "r")):
        with open(out / "snp_phasing" / f"{chrom}.haplotags.tsv", "w") as f:
            for i in (1, 2, 3):
                f.write(f"{names}{i}\t1\t1001\t900\n")
    result = run_phase_only(PipelineConfig(
        bam="unused.bam", reference="unused.fa", output=str(out)))
    body = [ln.split("\t") for ln in open(result)
            if ln.strip() and not ln.startswith("#")]
    assert [b[0] for b in body] == ["chr1", "chr2"]  # lexicographic
    assert all(b[9].startswith("1|0") for b in body)
