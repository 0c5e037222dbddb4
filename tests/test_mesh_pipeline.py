"""Full-pipeline byte parity: (dp, sp) device mesh vs single-device.

The production pipeline's mesh mode (PipelineConfig.mesh="DP,SP") runs the
haplotag-scoring stage through phase_and_tag_sharded (psum over dp and sp)
and SV clustering through cluster_sharded (ppermute coordinate halos).
These tests run BAM -> phased_sv.vcf on the 8-virtual-device CPU mesh and
pin every artifact byte-identical to the plain single-device run — the
multi-chip scaling contract of SURVEY.md §2.4.
"""

import gzip
import json
import os

import pytest

from duet_tpu.pipeline import PipelineConfig, run_pipeline


def _read(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


ARTIFACTS = ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf")


def _run(data_dir, out, **kw):
    cfg = PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out, **kw,
    )
    run_pipeline(cfg)
    return out


@pytest.mark.parametrize("mesh", ["4,2", "8,1", "2,4"])
def test_mesh_pipeline_matches_single_device(sim_dataset, tmp_path, mesh):
    data_dir, _, _ = sim_dataset
    base = _run(data_dir, str(tmp_path / "base"))
    meshed = _run(data_dir, str(tmp_path / f"mesh_{mesh.replace(',', 'x')}"),
                  mesh=mesh)
    for artifact in ARTIFACTS:
        assert _read(os.path.join(meshed, artifact)) == \
            _read(os.path.join(base, artifact)), f"mesh mismatch in {artifact}"
    final = _read(os.path.join(meshed, "phased_sv.vcf")).decode()
    assert sum(1 for ln in final.splitlines()
               if ln and not ln.startswith("#")) > 0
    with open(os.path.join(meshed, "metrics.json")) as f:
        metrics = json.load(f)
    dp, sp = (int(x) for x in mesh.split(","))
    assert metrics["mesh"] == {"dp": dp, "sp": sp}
    assert metrics["backends"]["haplotag"] == "mesh"
    assert metrics["backends"]["sv_cluster"] == "mesh"
    # round 5: the pileup stage shards over sp too — no single-device stage
    # remains
    assert metrics["backends"]["snp_pileup"] == "mesh"


def test_mesh_auto_resolves(sim_dataset, tmp_path):
    data_dir, _, _ = sim_dataset
    base = _run(data_dir, str(tmp_path / "base"))
    meshed = _run(data_dir, str(tmp_path / "auto"), mesh="auto")
    assert _read(os.path.join(meshed, "phased_sv.vcf")) == \
        _read(os.path.join(base, "phased_sv.vcf"))


def test_mesh_rejects_oversubscription(sim_dataset, tmp_path):
    data_dir, _, _ = sim_dataset
    with pytest.raises(ValueError, match="devices"):
        _run(data_dir, str(tmp_path / "over"), mesh="16,2")


def test_streaming_mesh_matches_batch(tmp_path):
    """Streaming mode composes with the device mesh: byte-identical
    phased_sv.vcf to the plain batch single-device run."""
    from duet_tpu.pipeline import run_pipeline_streaming
    from duet_tpu.sim import SimConfig, simulate_dataset

    d = tmp_path / "data"
    d.mkdir()
    simulate_dataset(str(d), SimConfig(contigs={"chrA": 120_000,
                                                "chrB": 120_000},
                                       seed=23, coverage=14.0))
    base = _run(str(d), str(tmp_path / "batch"), include_all_ctgs=True)
    cfg = PipelineConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
        output=str(tmp_path / "stream_mesh"), include_all_ctgs=True,
        mesh="4,2",
    )
    run_pipeline_streaming(cfg)
    got = _read(str(tmp_path / "stream_mesh" / "phased_sv.vcf"))
    assert got == _read(os.path.join(base, "phased_sv.vcf"))
    assert sum(1 for ln in got.decode().splitlines()
               if ln and not ln.startswith("#")) > 0


@pytest.mark.parametrize("geometry", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_pileup_parity_across_geometries(sim_dataset, geometry):
    """call_snps_sharded == the host caller, bit for bit, for every mesh
    geometry (counting is positional; window clipping cannot change any
    site's counts)."""
    import jax
    import numpy as np

    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store
    from duet_tpu.models.snp_caller import SnpCallConfig, call_contig_snps
    from duet_tpu.parallel.mesh import make_mesh
    from duet_tpu.parallel.shard_pileup import call_snps_sharded

    data_dir, _, _ = sim_dataset
    store = load_read_store(os.path.join(data_dir, "reads.bam"))
    ref = FastaFile(os.path.join(data_dir, "ref.fa"))
    cfg = SnpCallConfig()
    dp, sp = geometry
    mesh = make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])
    for contig, cr in store.contigs.items():
        codes = ref.fetch_codes(contig)
        host, _ = call_contig_snps(contig, cr, codes, cfg)
        sharded = call_snps_sharded(mesh, contig, cr, codes, cfg)
        np.testing.assert_array_equal(sharded.pos, host.pos)
        np.testing.assert_array_equal(sharded.alt_code, host.alt_code)
        np.testing.assert_array_equal(sharded.is_het, host.is_het)
        np.testing.assert_array_equal(sharded.depth, host.depth)
        np.testing.assert_array_equal(sharded.alt_count, host.alt_count)
        assert len(host.pos) > 0
