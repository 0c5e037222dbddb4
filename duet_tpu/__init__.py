"""duet_tpu — an accelerator-backed structural-variant calling & phasing
framework.

A from-scratch re-design of the capabilities of yekaizhou/duet
(SNP-assisted SV calling and phasing for ONT long reads) as a
self-contained framework whose hot stages run as JAX device kernels:

- ``duet_tpu.io``       — binary codecs: BGZF, BAM, FASTA/FAI, VCF
                          (replaces samtools/bcftools/tabix text round-trips,
                          reference: src/duet/read_file.py, write_file.py)
- ``duet_tpu.ops``      — JAX device kernels: pileup counting,
                          haplotype scoring, SV-signature clustering,
                          fused phase-decision
- ``duet_tpu.models``   — the pipeline stages ("model families"): SNP caller,
                          SNP phaser, read haplotagger, three SV-caller
                          families (cutesv/svim/sniffles-style), SV phaser
- ``duet_tpu.parallel`` — device-mesh runtime: sharded read batches,
                          collective merges, multi-host entry points
- ``duet_tpu.sim``      — diploid genome + ONT read simulator (test data)
- ``duet_tpu.eval``     — P/R/F1 evaluation harness
                          (reference: src/scripts/evaluation.py)
"""

__version__ = "0.1.0"
