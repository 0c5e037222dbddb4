"""Pipeline orchestrator: the four-stage BAM -> phased_sv.vcf flow.

Mirrors the reference driver's fixed stage order (src/duet/duet:23-26:
snp_calling -> sv_calling -> snp_phasing -> sv_phasing) and its on-disk
artifact contract (OUTPUT/snp_calling/pileup.vcf.gz, sv_calling/variants.vcf,
snp_phasing/phased_{chr}.vcf.gz, OUTPUT/phased_sv.vcf), with the framework
improvements SURVEY.md §5 calls out as gaps in the reference:

* one shared in-memory read store per run — the BAM is decoded once, not
  re-read per stage/chromosome (reference §3.3 redundant-I/O cost)
* every stage checks its own failure instead of ignored os.system codes
  (reference §5.3: errors surfaced only as downstream parse crashes)
* resume-from-artifacts: `resume=True` skips stages whose outputs exist
  (reference §5.4: artifacts persisted but always recomputed)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from duet_tpu.io.fasta import FastaFile
from duet_tpu.io.readstore import ReadStore, load_read_store
from duet_tpu.io.vcf import (
    append_phased_sv_records,
    parse_sv_vcf,
    write_phased_sv_header,
)
from duet_tpu.models import sv_phaser
from duet_tpu.models.snp_caller import (
    ContigSnps,
    SnpCallConfig,
    call_snps_for_store,
    read_pileup_vcf,
    write_pileup_vcf,
)
from duet_tpu.models.snp_phaser import (
    PhaseResult,
    phase_contig,
    read_hap_map,
    write_phased_snp_vcf,
)
from duet_tpu.models.sv_caller import SvCallConfig, write_sv_vcf
from duet_tpu.utils import devcost, dispatch
from duet_tpu.utils.chrom import resolve_contig_names, strip_chr
from duet_tpu.utils.logging import StageTimer, get_logger, setup_logging


@dataclass
class PipelineConfig:
    """Flag set with reference-CLI parity (src/duet/utils.py:19-44 defaults)."""

    bam: str
    reference: str
    output: str
    threads: int = 4                    # -t (ingest/host parallelism hint)
    min_allele_frequency: float = 0.25  # -m
    cluster_max_distance: float = 0.9   # -c
    sv_min_size: int = 50               # -s
    min_support_read: int = 2           # -r
    include_all_ctgs: bool = False      # -a
    sv_caller: str = "cutesv"           # -b: cutesv|sniffles -> gap linkage, svim -> span
    resume: bool = False                # skip stages whose artifacts exist
    use_device_kernel: bool = True      # run the decision stage on device
    haplotag_bam: bool = False          # also write per-contig HP/PC/PS BAMs
    phase_bnd: bool = False             # genotype+phase breakends too (the
                                        # reference drops them at the SVLEN
                                        # filter, sv_phasing_fn.py:189)
    decision_model: str = "verbatim"    # "verbatim" (the reference's T1-T5
                                        # tree, the parity contract) |
                                        # "learned" (CART refit on framework
                                        # features, models/decision_model)
    min_junction_evidence: float = 0.0  # split phase-set blocks at weak
                                        # junctions below an ABSOLUTE
                                        # evidence threshold (min(this,
                                        # block median/20)); superseded by
                                        # the adaptive rule below but kept
                                        # for explicit-threshold runs
    adaptive_junction_split: bool = True
                                        # coverage-adaptive weak-junction
                                        # splitting: split where converged
                                        # junction evidence is a >=20x
                                        # outlier vs the block median AND
                                        # spanning reads disagree (E/M <
                                        # 0.8) or number <=1.  No absolute
                                        # scale, so it does not backfire at
                                        # low coverage the way an absolute
                                        # threshold does (docs/PC_SCALE.md)
    # multi-process (multi-host) run: contigs are round-robin owned per
    # process, stage outputs exchanged as part-files on the shared
    # filesystem, process 0 is the single writer of the final artifacts
    # (SURVEY.md §5.8). coordinator wires jax.distributed; without it the
    # same ownership logic runs "emulated" (tested single-machine).
    num_processes: int | None = None
    process_id: int | None = None
    coordinator: str | None = None

    snp_model: str = "auto"             # "auto" (measured-envelope pick,
                                        # models/snp_caller.choose_snp_model)
                                        # | "counts" | "nn" (neural pileup
                                        # caller — Clair3's role)
    device_stages: str = "auto"         # route pileup counting + SV
                                        # clustering through the jitted
                                        # device kernels: "auto" (when an
                                        # accelerator backend is live),
                                        # "on" (force, e.g. CPU parity
                                        # tests), "off"
    mesh: str | None = None             # "DP,SP" or "auto": shard the
                                        # haplotag-scoring and clustering
                                        # stages over a (data-parallel,
                                        # sequence-parallel) device mesh
                                        # with in-graph XLA collectives
                                        # (SURVEY.md §2.4); outputs stay
                                        # byte-identical to single-device

    def stages_on_device(self) -> bool:
        if not self.use_device_kernel or self.device_stages == "off":
            return False
        if self.device_stages == "on":
            return True
        return _accelerator_live()

    def pileup_on_device(self) -> bool:
        """Device pileup ships the contig's packed reads host->device, and
        auto keeps the host count until a measurement shows the device
        winning (ROADMAP 1.2); --device-stages on forces
        the device path (bit-identical either way — the parity tests pin
        it)."""
        return self.use_device_kernel and self.device_stages == "on"

    # auto-gate sizes: below them the host path beats the device round
    # trips (bit-identical outputs either way).  Both were derived for a
    # fast host link before the H100 and were not measured on it
    # (ROADMAP 1.6 re-derives them).
    PHASING_GATE_NNZ = 1_000_000
    SV_GATE_K = 65536

    def phasing_device_min_nnz(self) -> int:
        """Size gate for the phasing stage's device kernels.  Scoring is
        BATCHED across contigs (snp_phaser.score_contigs_batched), so the
        gate applies to the run's combined nnz; the per-contig refine
        keeps the per-contig gate.  --device-stages on forces the device
        path at any size."""
        return 0 if self.device_stages == "on" else self.PHASING_GATE_NNZ

    def snp_cfg(self) -> SnpCallConfig:
        return SnpCallConfig(min_af=self.min_allele_frequency,
                             model=self.snp_model,
                             device=self.pileup_on_device())

    def sv_cfg(self) -> SvCallConfig:
        return SvCallConfig(
            linkage="span" if self.sv_caller == "svim" else "gap",
            cluster_max_distance=self.cluster_max_distance,
            min_size=self.sv_min_size,
            min_support=self.min_support_read,
            device=self.stages_on_device(),
            # "on" forces the kernel regardless of input size; auto keeps
            # the size gate — the kernel's compile/transfer latency only
            # amortizes on large signature sets
            device_min_k=0 if self.device_stages == "on" else self.SV_GATE_K,
        )


def _peak_rss_mb() -> float:
    """Peak resident set of this process in MB (ru_maxrss is KB on Linux)."""
    try:
        import resource

        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
    except Exception:
        return 0.0


def _accelerator_live() -> bool:
    """True when jax's default backend is an accelerator.  A backend that
    fails to initialise raises instead of reading as "no accelerator"."""
    import jax

    return jax.default_backend() != "cpu"


_JAX_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache() -> None:
    """Persistent jit-compile cache, so device-kernel compiles are paid
    once per cache, not once per run.  JAX_COMPILATION_CACHE_DIR wins when
    set (jax reads it itself); otherwise a fixed directory inside the
    checkout — the path is part of the cache key, so it must not move."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _JAX_CACHE_DIR)
    # 0.0: the pipeline's kernels are many and each compiles in well under
    # jax's default 1 s threshold, which would keep every one of them out
    # of the cache
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def check_envs(cfg: PipelineConfig) -> None:
    """Pre-flight index checks (reference utils.py:46-50 exits unless
    BAM.bai and REF.fai exist)."""
    missing = [p for p in (cfg.bam, cfg.reference, cfg.bam + ".bai",
                           cfg.reference + ".fai") if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            "missing required input(s): " + ", ".join(missing)
            + " (BAM and reference must be indexed)"
        )


@dataclass
class PipelineState:
    """In-memory data plane shared across stages (alongside disk artifacts)."""

    store: ReadStore | None = None
    ref: FastaFile | None = None
    snps: dict[str, ContigSnps] = field(default_factory=dict)
    site_obs: dict[str, tuple] = field(default_factory=dict)
    sv_calls: dict[str, list] = field(default_factory=dict)
    phase_results: dict[str, PhaseResult] = field(default_factory=dict)
    read_haps: dict[str, dict[str, tuple[int, int, int]]] = field(default_factory=dict)
    mesh: object | None = None  # resolved jax.sharding.Mesh (cfg.mesh)


def _resolve_mesh(cfg: PipelineConfig):
    """Build the (dp, sp) device mesh from cfg.mesh ('DP,SP' or 'auto')."""
    if cfg.mesh is None:
        return None
    import jax

    from duet_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    if cfg.mesh == "auto":
        sp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // sp
    else:
        dp, sp = (int(x) for x in cfg.mesh.split(","))
        if dp * sp > n:
            raise ValueError(
                f"--mesh {cfg.mesh} needs {dp * sp} devices, have {n}")
    get_logger().info("device mesh: dp=%d sp=%d (%d devices)", dp, sp, dp * sp)
    return make_mesh(dp=dp, sp=sp)


def _proc(cfg: PipelineConfig) -> tuple[int, int]:
    """Resolved (process_id, num_processes). Explicit config wins (emulated
    multi-process testing); else the live jax.distributed values.  Plain
    single-process runs never touch jax here — multi-host is only ever wired
    through cfg.coordinator (init_distributed), so without it the process
    topology is trivially (0, 1) and host-kernel runs skip backend init."""
    if cfg.num_processes is not None:
        if cfg.num_processes > 1 and cfg.process_id is None:
            raise ValueError("--num-processes > 1 requires --process-id")
        pid = cfg.process_id or 0
        if not 0 <= pid < cfg.num_processes:
            raise ValueError(
                f"process_id {pid} out of range for {cfg.num_processes} processes")
        return pid, cfg.num_processes
    if cfg.coordinator is None:
        return 0, 1
    import jax

    return jax.process_index(), jax.process_count()


def _owned_contigs(names: list[str], pid: int, nproc: int) -> list[str]:
    """Round-robin contig ownership over the sorted contig list — every
    process derives the same assignment independently."""
    ordered = sorted(names)
    return [c for i, c in enumerate(ordered) if i % nproc == pid]


def _barrier(cfg: PipelineConfig, name: str) -> None:
    """Cross-process rendezvous; a no-op when emulated (the test harness
    sequences the processes) or single-process."""
    if cfg.coordinator is None:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def _parts_dir(cfg: PipelineConfig) -> str:
    d = os.path.join(cfg.output, "parts")
    os.makedirs(d, exist_ok=True)
    return d


def _dump_part(cfg: PipelineConfig, stage: str, pid: int, payload) -> None:
    import pickle

    path = os.path.join(_parts_dir(cfg), f"{stage}.part{pid}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic: readers never see a torn part


def _load_parts(cfg: PipelineConfig, stage: str, nproc: int) -> list:
    import pickle

    out = []
    for pid in range(nproc):
        path = os.path.join(_parts_dir(cfg), f"{stage}.part{pid}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def _work_contigs(cfg: PipelineConfig, available: list[str]) -> list[str]:
    """Contigs to process, honoring -a and accepting chrN/N spellings."""
    canonical = resolve_contig_names(available, cfg.include_all_ctgs)
    out = []
    for name in canonical:
        for c in available:
            if c == name or c == "chr" + name or strip_chr(c) == name:
                out.append(c)
                break
    return out


def stage_snp_calling(cfg: PipelineConfig, st: PipelineState) -> None:
    out_dir = os.path.join(cfg.output, "snp_calling")
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, "pileup.vcf.gz")
    if cfg.resume and os.path.exists(artifact):
        get_logger().info("resume: loading %s", artifact)
        st.snps = read_pileup_vcf(artifact)
        return
    # key reference codes by the STORE's contig spelling so a chrN BAM
    # against an N-named FASTA (or vice versa) still matches
    work_fa = _work_contigs(cfg, st.ref.contig_names)
    ref_codes = {}
    for store_name in st.store.contigs:
        for fa_name in work_fa:
            if strip_chr(store_name) == strip_chr(fa_name):
                ref_codes[store_name] = st.ref.fetch_codes(fa_name)
                break
    st.snps, st.site_obs = call_snps_for_store(
        st.store, ref_codes, cfg.snp_cfg(), threads=cfg.threads,
        mesh=st.mesh)
    pid, nproc = _proc(cfg)
    if nproc > 1:
        # multi-process: the canonical pileup.vcf.gz is merged and written
        # by process 0 at the final stage
        _dump_part(cfg, "snp", pid, (st.snps, st.store.contig_lengths))
    else:
        write_pileup_vcf(artifact, st.snps, st.store.contig_lengths)
    n = sum(len(s.pos) for s in st.snps.values())
    get_logger().info("called %d SNP sites over %d contigs", n, len(st.snps))


def stage_sv_calling(cfg: PipelineConfig, st: PipelineState) -> None:
    out_dir = os.path.join(cfg.output, "sv_calling")
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, "variants.vcf")
    if cfg.resume and os.path.exists(artifact):
        get_logger().info("resume: keeping %s", artifact)
        return
    sv_cfg = cfg.sv_cfg()
    from duet_tpu.models.sv_caller import call_bnds, call_contig_with_evidence

    work = list(st.store.contigs.items())
    if cfg.threads > 1 and len(work) > 1 and st.mesh is None:
        # contig fan-out like the SNP stages (-t semantics; the reference
        # forwards -t to its external callers, sv_calling.py:18).  Mesh
        # runs go contig-serial: the collectives already occupy every
        # device, and serial dispatch keeps them deterministic.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(cfg.threads) as ex:
            results = list(ex.map(
                lambda kv: (kv[0], call_contig_with_evidence(kv[1], sv_cfg)),
                work))
    else:
        results = [(c, call_contig_with_evidence(cr, sv_cfg, mesh=st.mesh))
                   for c, cr in work]
    calls = {c: r[0] for c, r in results}
    evidence = {c: r[1] for c, r in results}
    st.sv_calls = calls  # the phasing stage protects their support spans
    pid, nproc = _proc(cfg)
    if nproc > 1:
        # per-contig calls + breakend evidence travel as a part-file:
        # breakend junctions may pair contigs owned by DIFFERENT processes,
        # so clustering runs globally on process 0 over the merged evidence
        _dump_part(cfg, "sv", pid,
                   (calls, evidence, st.store.contig_lengths))
        n = sum(len(v) for v in calls.values())
        get_logger().info("clustered %d SV candidates (part %d/%d)",
                          n, pid, nproc)
        return
    bnds = call_bnds(evidence, sv_cfg)
    write_sv_vcf(artifact, calls, st.store.contig_lengths,
                 family=cfg.sv_caller, bnds=bnds)
    n = sum(len(v) for v in calls.values())
    get_logger().info("clustered %d SV candidates + %d breakend pairs",
                      n, len(bnds))


def _sv_protect_intervals(cfg: PipelineConfig, st: PipelineState, contig: str,
                          cr=None):
    """Support-read span table of the contig's candidate SV calls (the ones
    that will reach the decision stage): weak-junction splitting must not
    cut a phase set inside these spans, or the call lands in the
    conservative two-PS regime and loses calling/genotyping recall
    (reference semantics sv_phasing_fn.py:86-105)."""
    from duet_tpu.models.snp_phaser import support_read_intervals

    cr = cr if cr is not None else st.store.contigs.get(contig)
    calls = st.sv_calls.get(contig)
    if not calls or cr is None:
        return None
    names: set[str] = set()
    for c in calls:
        length = abs(getattr(c, "length", None) or getattr(c, "svlen", 0))
        if length >= cfg.sv_min_size and c.support >= cfg.min_support_read \
                and c.gt != "./.":
            names.update(c.read_names)
    if not names:
        return None
    return support_read_intervals(cr, names)


def stage_snp_phasing(cfg: PipelineConfig, st: PipelineState) -> None:
    out_dir = os.path.join(cfg.output, "snp_phasing")
    os.makedirs(out_dir, exist_ok=True)
    if cfg.resume and not st.sv_calls:
        # resumed run: the calls the protection intervals need live only in
        # the artifact — parse it ONCE here, not per contig inside the
        # thread pool
        variants = os.path.join(cfg.output, "sv_calling", "variants.vcf")
        if os.path.exists(variants):
            parsed = parse_sv_vcf(variants, True)
            # parse_sv_vcf canonicalizes contig spellings; key the table by
            # the store's names so per-contig lookups hit
            for c in st.store.contigs:
                # try the store spelling, then both alias directions (an
                # unprefixed store contig must still find a 'chr1' key —
                # mirrors the fasta-name alias logic above)
                for key in (c, strip_chr(c), "chr" + strip_chr(c)):
                    if key in parsed:
                        st.sv_calls[c] = parsed[key]
                        break

    work = [(c, s) for c, s in st.snps.items() if c in st.store.contigs]
    if st.mesh is None:
        # batched scoring: the refine/correct loop runs per contig (its
        # host-side switch correction interleaves with device sweeps), but
        # the final scoring launch is ONE batched device call across
        # contigs — the per-call device floor amortizes, and several
        # sub-gate contigs can cross the device gate together (their
        # combined nnz decides; bit-identical either way)
        from duet_tpu.models.snp_phaser import (
            phase_contig_core,
            score_contigs_batched,
        )

        def core(item):
            contig, snps = item
            cr = st.store.contigs[contig]
            return contig, phase_contig_core(
                cr, snps, cfg.snp_cfg(),
                use_device=cfg.use_device_kernel,
                obs=st.site_obs.get(contig),
                min_junction_evidence=cfg.min_junction_evidence,
                device_min_nnz=cfg.phasing_device_min_nnz(),
                adaptive_junction_split=cfg.adaptive_junction_split,
                protect_intervals=_sv_protect_intervals(cfg, st, contig))

        if cfg.threads > 1 and len(work) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(cfg.threads) as ex:
                cores = dict(ex.map(core, work))
        else:
            cores = dict(map(core, work))
        scored = score_contigs_batched(
            cores, cfg.use_device_kernel, cfg.phasing_device_min_nnz())
        results = [(c, s, st.store.contigs[c], scored[c]) for c, s in work]
    else:
        results = [
            (c, s, st.store.contigs[c],
             phase_contig(st.store.contigs[c], s, cfg.snp_cfg(),
                          use_device=cfg.use_device_kernel,
                          obs=st.site_obs.get(c), mesh=st.mesh,
                          min_junction_evidence=cfg.min_junction_evidence,
                          device_min_nnz=cfg.phasing_device_min_nnz(),
                          adaptive_junction_split=cfg.adaptive_junction_split,
                          protect_intervals=_sv_protect_intervals(cfg, st, c)))
            for c, s in work
        ]

    for contig, snps, cr, result in results:
        st.phase_results[contig] = result
        st.read_haps[contig] = read_hap_map(cr, result)
        write_phased_snp_vcf(
            os.path.join(out_dir, f"phased_{contig}.vcf.gz"), contig, snps, result
        )
        _write_haplotag_table(
            os.path.join(out_dir, f"{contig}.haplotags.tsv"), st.read_haps[contig]
        )
        if cfg.haplotag_bam:
            _write_haplotag_bam(
                os.path.join(out_dir, f"{contig}.bam"), cr,
                st.read_haps[contig], st.store.contig_lengths,
            )
        n_reads = len(result.row_names) if result.row_names else cr.n
        get_logger().info(
            "[PHASING] %s: %d het sites, %d blocks, %d/%d reads tagged",
            contig, len(result.site_pos), len(result.block_ps),
            int((result.read_hap != 0).sum()), n_reads,
        )


def _write_haplotag_table(path: str, haps: dict[str, tuple[int, int, int]]) -> None:
    """name<TAB>hap<TAB>ps<TAB>pc — the framework's equivalent of the
    haplotagged-BAM HP/PC/PS artifact (reference snp_phasing.py:27-29)."""
    with open(path, "w") as f:
        for name, (hap, ps, pc) in haps.items():
            f.write(f"{name}\t{hap}\t{ps}\t{pc}\n")


def _write_haplotag_bam(path: str, cr, haps: dict[str, tuple[int, int, int]],
                        contig_lengths: dict[str, int]) -> None:
    """Per-contig haplotagged BAM with HP/PC/PS tags — byte-level artifact
    parity with the reference's WhatsHap haplotag output contract
    (snp_phasing.py:27-29), for IGV/downstream consumers."""
    import numpy as np

    from duet_tpu.io.bam import BamHeader, BamRead, BamWriter, write_bam_index

    length = contig_lengths.get(cr.contig, 0)
    header = BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cr.contig}\tLN:{length}\n",
        [cr.contig], [length],
    )
    with BamWriter(path, header) as w:
        for i in range(cr.n):
            tags = {}
            t = haps.get(cr.names[i])
            if t is not None:
                hap, ps, pc = t
                tags = {"HP": hap, "PC": pc, "PS": ps}
            flag = (0x10 if cr.strand[i] else 0) | (0x800 if cr.supp[i] else 0)
            ops = cr.cigar_ops[cr.cigar_off[i]:cr.cigar_off[i + 1]]
            lens = cr.cigar_lens[cr.cigar_off[i]:cr.cigar_off[i + 1]]
            cigar = np.stack([ops.astype(np.int32), lens], axis=1) \
                if len(ops) else np.zeros((0, 2), np.int32)
            w.write(BamRead(
                cr.names[i], flag, 0, int(cr.starts[i]), int(cr.mapq[i]),
                cigar, cr.seq[cr.seq_off[i]:cr.seq_off[i + 1]],
                cr.qual[cr.seq_off[i]:cr.seq_off[i + 1]], tags,
            ))
    write_bam_index(path)


def read_haplotag_table(path: str) -> dict[str, tuple[int, int, int]]:
    out = {}
    with open(path) as f:
        for line in f:
            name, hap, ps, pc = line.rstrip("\n").split("\t")
            out[name] = (int(hap), int(ps), int(pc))
    return out


def _bam_order(cfg: PipelineConfig, d: dict) -> dict:
    """Reorder a per-contig dict to the BAM header's contig order — the
    order a single-process run iterates in, so merged multi-process
    artifacts stay byte-identical (lexicographic sort would swap e.g.
    chr10 before chr2)."""
    from duet_tpu.io.bam import BamReader

    with BamReader(cfg.bam) as r:
        rank = {n: i for i, n in enumerate(r.header.ref_names)}
    return dict(sorted(d.items(), key=lambda kv: rank.get(kv[0], len(rank))))


def _merge_parts_and_write(cfg: PipelineConfig, nproc: int) -> None:
    """Process 0: fuse every part-file into the canonical single-process
    artifacts (pileup.vcf.gz, variants.vcf incl. globally clustered
    breakends) — from here on the final stage is identical to a
    single-process run."""
    from duet_tpu.models.sv_caller import call_bnds

    snps: dict = {}
    lengths: dict[str, int] = {}
    for part_snps, part_lengths in _load_parts(cfg, "snp", nproc):
        snps.update(part_snps)
        lengths.update(part_lengths)
    snps = _bam_order(cfg, snps)
    write_pileup_vcf(os.path.join(cfg.output, "snp_calling", "pileup.vcf.gz"),
                     snps, lengths)

    calls: dict = {}
    evidence: dict = {}
    for part_calls, part_ev, part_lengths in _load_parts(cfg, "sv", nproc):
        calls.update(part_calls)
        evidence.update(part_ev)
        lengths.update(part_lengths)
    calls = _bam_order(cfg, calls)
    bnds = call_bnds(evidence, cfg.sv_cfg())
    write_sv_vcf(os.path.join(cfg.output, "sv_calling", "variants.vcf"),
                 calls, lengths, family=cfg.sv_caller, bnds=bnds)
    get_logger().info(
        "merged %d part(s): %d contigs, %d breakend pairs", nproc,
        len(calls), len(bnds),
    )


def stage_sv_phasing(cfg: PipelineConfig, st: PipelineState) -> None:
    pid, nproc = _proc(cfg)
    if nproc > 1:
        _barrier(cfg, "pre-merge")
        if pid != 0:
            return  # single-writer emission on process 0 (SURVEY.md §5.8)
        _merge_parts_and_write(cfg, nproc)
    variants = os.path.join(cfg.output, "sv_calling", "variants.vcf")
    artifact = os.path.join(cfg.output, "phased_sv.vcf")
    if not os.path.exists(variants):
        raise FileNotFoundError(f"sv_calling artifact missing: {variants}")
    # -a contig list comes from the SNP-calling artifact when present —
    # the reference's init_chrom_list runs `tabix --list-chroms` on
    # snp_calling/pileup.vcf.gz (read_file.py:13-15), so a contig with SV
    # calls but no pileup entry is skipped; fall back to the variants
    # file's own contigs when the pileup artifact is absent
    chrom_list = None
    if cfg.include_all_ctgs:
        pileup = os.path.join(cfg.output, "snp_calling", "pileup.vcf.gz")
        if os.path.exists(pileup):
            from duet_tpu.io.vcf import list_chroms

            chrom_list = list_chroms(pileup)
    per_chrom = parse_sv_vcf(variants, cfg.include_all_ctgs,
                             chrom_list=chrom_list)
    have = {strip_chr(c) for c in st.read_haps}
    missing = [c for c in per_chrom if strip_chr(c) not in have]
    if missing:
        # resume / phase-only / multi-process path: reload per-chromosome
        # read->haplotype maps from disk — framework .haplotags.tsv tables
        # or reference-style haplotagged {chr}.bam files (other processes'
        # contigs arrive this way)
        from duet_tpu.io.haplotag_bam import read_hap_tables_from_dir

        st.read_haps.update(read_hap_tables_from_dir(
            os.path.join(cfg.output, "snp_phasing"), missing
        ))
    # align read-hap map keys to the parser's canonical names
    read_haps = {}
    for name in per_chrom:
        for contig, m in st.read_haps.items():
            if contig == name or strip_chr(contig) == strip_chr(name):
                read_haps[name] = m
                break
    # decision-stage device gate, same policy as the other stages: the
    # kernel is latency-bound below tens of thousands of calls (host float64
    # path is bit-identical); --device-stages on forces it at any size
    n_calls = sum(len(v) for v in per_chrom.values())
    decide_on_device = cfg.use_device_kernel and (
        cfg.device_stages == "on" or n_calls >= 65536)
    phased = sv_phaser.phase_callset(
        per_chrom, read_haps, cfg.sv_min_size, cfg.min_support_read,
        use_device=decide_on_device, phase_bnd=cfg.phase_bnd,
        decision_model=cfg.decision_model,
    )
    write_phased_sv_header(variants, artifact, cfg.include_all_ctgs)
    append_phased_sv_records(phased, artifact)
    get_logger().info("phased %d SV calls -> %s", len(phased), artifact)


def _ingest(cfg: PipelineConfig,
            only_contigs: set[str] | None = None) -> tuple[ReadStore, str]:
    """Native C++ BAM decode (streaming, threaded BGZF inflate + parallel
    record parse) with Python fallback.  Returns (store, backend_name).

    only_contigs: multi-process ownership filter — applied DURING decode by
    the native reader (non-owned contigs' records are skipped at scan time,
    never column-decoded)."""
    try:
        from duet_tpu.io.native_ingest import load_read_store_native

        # inflate threads beyond the physical cores only add contention
        n_threads = min(cfg.threads, os.cpu_count() or cfg.threads)
        store = load_read_store_native(cfg.bam, n_threads=n_threads,
                                       only_contigs=only_contigs)
        get_logger().info("ingest backend: native")
        return store, "native"
    except Exception as e:  # NativeUnavailable or build/runtime failure
        get_logger().warning("native ingest unavailable (%s); using Python reader", e)
        return load_read_store(cfg.bam, only_contigs=only_contigs), "python"


STAGES = (
    ("SNP CALLING", stage_snp_calling),
    ("SV CALLING", stage_sv_calling),
    ("SNP PHASING", stage_snp_phasing),
    ("SV PHASING", stage_sv_phasing),
)


def run_pipeline_streaming(cfg: PipelineConfig) -> str:
    """Contig-major streaming run for memory-bounded whole-genome inputs.

    Instead of decoding the whole BAM up front, each coordinate-sorted
    contig is decoded, SNP-called, SV-called, phased and haplotagged, then
    released — peak memory is one contig's reads (the reference's
    per-chromosome GNU-parallel layout had the same bound, SURVEY.md §3.3).
    The final cross-contig SV-phasing stage runs once at the end.  Output
    artifacts are identical to run_pipeline's."""
    import time

    from duet_tpu.io.readstore import stream_contig_reads_auto
    from duet_tpu.models.sv_caller import call_bnds, call_contig_with_evidence

    if (cfg.num_processes or 1) > 1:
        raise ValueError("--stream does not combine with multi-process runs; "
                         "use one mode or the other")
    check_envs(cfg)
    os.makedirs(cfg.output, exist_ok=True)
    setup_logging(cfg.output)
    if cfg.use_device_kernel:
        _enable_compilation_cache()
    log = get_logger()
    t0 = time.time()
    dispatch.reset()
    devcost.reset()

    st = PipelineState()
    st.mesh = _resolve_mesh(cfg)
    st.ref = FastaFile(cfg.reference)
    snp_dir = os.path.join(cfg.output, "snp_calling")
    sv_dir = os.path.join(cfg.output, "sv_calling")
    ph_dir = os.path.join(cfg.output, "snp_phasing")
    for d in (snp_dir, sv_dir, ph_dir):
        os.makedirs(d, exist_ok=True)

    aliases = {}
    for canonical in _work_contigs(cfg, st.ref.contig_names):
        aliases[canonical] = canonical
        aliases[strip_chr(canonical)] = canonical
        aliases["chr" + strip_chr(canonical)] = canonical

    snps_all: dict[str, ContigSnps] = {}
    calls_all: dict[str, list] = {}
    bnd_evidence: dict = {}
    lengths: dict[str, int] = {}
    n_reads = 0
    # per-stage attribution across the contig loop: cumulative seconds and
    # the RSS high-water mark observed right after each stage (ru_maxrss is
    # monotone, so the stage where a value first jumps is where the memory
    # peak formed)
    stage_s = {"ingest": 0.0, "snp_calling": 0.0, "sv_calling": 0.0,
               "snp_phasing": 0.0}
    stage_rss = dict.fromkeys(stage_s, 0.0)

    def _mark(stage: str, t_start: float) -> None:
        stage_s[stage] += time.perf_counter() - t_start
        stage_rss[stage] = max(stage_rss[stage], _peak_rss_mb())

    from duet_tpu.io.readstore import prefetch_iter

    stream, stream_backend = stream_contig_reads_auto(
        cfg.bam, n_threads=cfg.threads)
    # double-buffer: contig N+1 decodes on a background thread while the
    # stages process contig N (peak memory becomes two contigs' columns;
    # the "ingest" stage time below is then the residual STALL waiting
    # for decode, not the full decode wall).  Only with spare cores: on
    # fewer than 4 the decode threads and the CPU-bound stages just
    # time-slice, while a machine with cores to spare hides the smaller
    # of the two entirely.
    try:
        n_cores = len(os.sched_getaffinity(0))  # honors cgroup/taskset
    except AttributeError:  # non-Linux
        n_cores = os.cpu_count() or 1
    prefetch = n_cores >= 4
    if prefetch:
        stream = prefetch_iter(stream, depth=1)
    log.info("streaming ingest backend: %s%s", stream_backend,
             " (prefetch depth 1)" if prefetch else "")
    with StageTimer("STREAMING CONTIG PASS"):
        t_iter = time.perf_counter()
        for cr, contig_lengths in stream:
            _mark("ingest", t_iter)  # generator time = decode time
            if cr.contig not in aliases:
                t_iter = time.perf_counter()
                continue
            if cr.contig in snps_all:
                # one segment per contiguous run: a repeated contig key means
                # the BAM is not coordinate-sorted, and the first segment's
                # results were already computed and released — silently
                # keeping the last segment would drop reads (batch mode
                # concatenates segments instead)
                raise ValueError(
                    f"--stream requires a coordinate-sorted BAM: contig "
                    f"{cr.contig} appears in multiple stream segments; "
                    "run without --stream (batch mode merges segments)"
                )
            lengths.update(contig_lengths)
            n_reads += cr.n
            fa_name = aliases[cr.contig] if aliases[cr.contig] in st.ref.index \
                else cr.contig
            t = time.perf_counter()
            codes = st.ref.fetch_codes(fa_name)
            _mark("ingest", t)  # reference load is ingest, not SNP calling
            from duet_tpu.models.snp_caller import (
                _at_site_obs,
                call_contig_snps,
                mesh_pileup_ok,
            )

            t = time.perf_counter()
            snp_cfg = cfg.snp_cfg()
            if st.mesh is not None and mesh_pileup_ok(snp_cfg):
                # coordinate-sharded pileup over sp (parallel.shard_pileup;
                # bit-identical to the host caller — tests pin it)
                from duet_tpu.parallel.shard_pileup import call_snps_sharded

                snps = call_snps_sharded(st.mesh, cr.contig, cr, codes,
                                         snp_cfg)
                site_obs = _at_site_obs(cr, snp_cfg, snps.pos)
            else:
                snps, site_obs = call_contig_snps(cr.contig, cr, codes,
                                                  snp_cfg)
            snps_all[cr.contig] = snps
            _mark("snp_calling", t)
            # cross-contig breakend evidence survives the contig's release
            t = time.perf_counter()
            calls_all[cr.contig], bnd_evidence[cr.contig] = \
                call_contig_with_evidence(cr, cfg.sv_cfg(), mesh=st.mesh)
            st.sv_calls[cr.contig] = calls_all[cr.contig]
            _mark("sv_calling", t)
            t = time.perf_counter()
            result = phase_contig(cr, snps, cfg.snp_cfg(),
                                  use_device=cfg.use_device_kernel,
                                  obs=site_obs, mesh=st.mesh,
                                  min_junction_evidence=cfg.min_junction_evidence,
                                  device_min_nnz=cfg.phasing_device_min_nnz(),
                                  adaptive_junction_split=cfg.adaptive_junction_split,
                                  protect_intervals=_sv_protect_intervals(
                                      cfg, st, cr.contig, cr=cr))
            st.read_haps[cr.contig] = read_hap_map(cr, result)
            write_phased_snp_vcf(
                os.path.join(ph_dir, f"phased_{cr.contig}.vcf.gz"),
                cr.contig, snps, result,
            )
            _write_haplotag_table(
                os.path.join(ph_dir, f"{cr.contig}.haplotags.tsv"),
                st.read_haps[cr.contig],
            )
            _mark("snp_phasing", t)
            log.info("[STREAM] %s: %d reads, %d SNPs, %d SV candidates, "
                     "%d blocks", cr.contig, cr.n, len(snps.pos),
                     len(calls_all[cr.contig]), len(result.block_ps))
            st.ref.drop_cache(fa_name)
            t_iter = time.perf_counter()
    write_pileup_vcf(os.path.join(snp_dir, "pileup.vcf.gz"), snps_all, lengths)
    write_sv_vcf(os.path.join(sv_dir, "variants.vcf"), calls_all, lengths,
                 family=cfg.sv_caller, bnds=call_bnds(bnd_evidence, cfg.sv_cfg()))
    st.snps = snps_all
    with StageTimer("SV PHASING"):
        t = time.perf_counter()
        stage_sv_phasing(cfg, st)
        stage_s["sv_phasing"] = time.perf_counter() - t
        stage_rss["sv_phasing"] = _peak_rss_mb()
    total = round(time.time() - t0, 4)
    log.info("ALL STAGES COMPLETED IN %ss (streamed %d reads)", total, n_reads)
    # observability parity with run_pipeline (SURVEY.md §5.1 gap)
    import json

    snap = dispatch.snapshot()
    ingest_block: dict = {"backend": stream_backend}
    if stream_backend == "native":
        from duet_tpu.io import native_ingest as _ni

        if _ni.LAST_DECODE_STATS is not None:
            # interior split of the native decode —
            # same nested key as batch mode so artifact consumers read
            # one shape: metrics["ingest"]["native"]
            ingest_block["native"] = _ni.LAST_DECODE_STATS
    with open(os.path.join(cfg.output, "metrics.json"), "w") as f:
        json.dump({
            "mode": "streaming",
            "ingest_backend": stream_backend,
            "ingest": ingest_block,
            "backends": {s: dispatch.backend_label(s, snap)
                         for s in dispatch.STAGES},
            "device_dispatch": snap,
            # per-stage h2d/compute/d2h split (utils.devcost) — a slow
            # device stage is attributable from the artifact itself
            "device_cost": devcost.snapshot(),
            "stages": {k: round(v, 4) for k, v in stage_s.items()},
            "stage_peak_rss_mb": {k: round(v, 1)
                                  for k, v in stage_rss.items()},
            "peak_rss_mb": _peak_rss_mb(),
            "counts": {
                "reads": n_reads,
                "contigs": len(snps_all),
                "snp_sites": sum(len(s.pos) for s in snps_all.values()),
                "sv_candidates": sum(len(v) for v in calls_all.values()),
                "tagged_reads": sum(len(m) for m in st.read_haps.values()),
            },
            "total_s": total,
            "reads_per_s": round(n_reads / max(total, 1e-9), 1),
        }, f, indent=2)
    return os.path.join(cfg.output, "phased_sv.vcf")


def pileup_observations_for(cr, cfg: PipelineConfig):
    from duet_tpu.models.snp_caller import pileup_observations

    return pileup_observations(cr, cfg.snp_cfg())


def run_phase_only(cfg: PipelineConfig) -> str:
    """Final stage only, from on-disk artifacts.

    Drop-in compatibility with the reference data plane: OUTPUT must hold
    sv_calling/variants.vcf (any supported caller format) and snp_phasing/
    with either .haplotags.tsv tables or reference-style haplotagged
    per-chromosome BAMs carrying HP/PC/PS tags.  Lets reference users
    re-phase their existing intermediates, and is the parity surface for
    comparing final VCFs against the reference on identical inputs."""
    if (cfg.num_processes or 1) > 1:
        raise ValueError("--phase-only is a single-process mode")
    os.makedirs(cfg.output, exist_ok=True)
    setup_logging(cfg.output)
    st = PipelineState()
    with StageTimer("SV PHASING"):
        stage_sv_phasing(cfg, st)
    return os.path.join(cfg.output, "phased_sv.vcf")


def run_pipeline(cfg: PipelineConfig) -> str:
    """Run all stages; returns the phased_sv.vcf path.

    Observability beyond the reference's wall-clock lines (SURVEY.md §5.1):
    OUTPUT/metrics.json records per-stage seconds, read/site/call counts,
    and ingest throughput for machine consumption."""
    import json
    import time

    check_envs(cfg)
    os.makedirs(cfg.output, exist_ok=True)
    if cfg.coordinator is not None:
        from duet_tpu.parallel.distributed import init_distributed

        init_distributed(cfg.coordinator, cfg.num_processes, cfg.process_id)
    pid, nproc = _proc(cfg)
    if nproc > 1 and cfg.resume:
        raise ValueError("--resume does not combine with multi-process runs: "
                         "stage outputs live in part files, not the "
                         "single-process artifacts resume checks")
    setup_logging(cfg.output, file_name="run_duet.log" if pid == 0
                  else f"run_duet.p{pid}.log")
    if cfg.use_device_kernel:
        _enable_compilation_cache()
    log = get_logger()
    if nproc > 1:
        log.info("multi-process run: process %d of %d", pid, nproc)

    t0 = time.time()
    dispatch.reset()  # fresh per-run accounting (bench runs several in-process)
    devcost.reset()
    st = PipelineState()
    st.mesh = _resolve_mesh(cfg)
    metrics: dict = {"stages": {}, "counts": {}}
    with StageTimer("INGEST"):
        t = time.time()
        st.ref = FastaFile(cfg.reference)
        fasta_s = time.time() - t
        owned = None
        if nproc > 1:
            from duet_tpu.io.bam import BamReader

            with BamReader(cfg.bam) as r:
                bam_names = list(r.header.ref_names)
            work = _work_contigs(cfg, bam_names)
            owned = set(_owned_contigs(work, pid, nproc))
            log.info("owned contigs: %s", sorted(owned))
        t_bam = time.time()
        st.store, ingest_backend = _ingest(cfg, only_contigs=owned)
        bam_s = time.time() - t_bam
        n_reads = sum(c.n for c in st.store.contigs.values())
        metrics["stages"]["ingest"] = round(time.time() - t, 4)
        metrics["counts"]["reads"] = n_reads
        metrics["counts"]["contigs"] = len(st.store.contigs)
        # attribution inside the ingest stage: .fai index read vs BAM
        # decode, plus the BAM
        # decoder's own throughput — the pipeline-level reads_per_s below
        # includes the FASTA side
        metrics["ingest"] = {
            "backend": ingest_backend,
            "fasta_index_s": round(fasta_s, 4),
            "bam_decode_s": round(bam_s, 4),
            "bam_decode_reads_per_s": round(n_reads / max(bam_s, 1e-9), 1),
        }
        # interior split of the native decode (inflate vs scan vs column
        # fill, byte volumes, page-fault deltas)
        if ingest_backend == "native":
            from duet_tpu.io import native_ingest as _ni

            if _ni.LAST_DECODE_STATS is not None:
                metrics["ingest"]["native"] = _ni.LAST_DECODE_STATS
        metrics["ingest_reads_per_s"] = round(
            n_reads / max(time.time() - t, 1e-9), 1
        )
        log.info("ingested %d reads over %d contigs", n_reads, len(st.store.contigs))
    for name, fn in STAGES:
        with StageTimer(name):
            t = time.time()
            fn(cfg, st)
            metrics["stages"][name.lower().replace(" ", "_")] = round(time.time() - t, 4)
    # labels reflect what actually RAN (kernel invocation counts), not what
    # the flags enabled — auto mode's size gates route small inputs to the
    # host regardless of config
    snap = dispatch.snapshot()
    metrics["backends"] = {s: dispatch.backend_label(s, snap)
                           for s in dispatch.STAGES}
    metrics["device_dispatch"] = snap
    # per-stage h2d/compute/d2h seconds + bytes (utils.devcost): the
    # device-path cost split, so "transfer-bound" is checkable in-artifact
    metrics["device_cost"] = devcost.snapshot()
    if st.mesh is not None:
        metrics["mesh"] = {"dp": int(st.mesh.shape["dp"]),
                           "sp": int(st.mesh.shape["sp"])}
    if cfg.device_stages == "auto":
        # auto device backends are size-gated: inputs below these floors run
        # on the host (bit-identical), because kernel round-trip/compile
        # latency only amortizes on large inputs
        metrics["device_size_gates"] = {
            "sv_cluster_min_signatures": cfg.sv_cfg().device_min_k,
            "phasing_min_nnz": cfg.phasing_device_min_nnz(),
        }
    metrics["counts"]["snp_sites"] = sum(len(s.pos) for s in st.snps.values())
    metrics["counts"]["tagged_reads"] = sum(
        len(m) for m in st.read_haps.values()
    )
    metrics["total_s"] = round(time.time() - t0, 4)
    metrics["peak_rss_mb"] = _peak_rss_mb()
    metrics_name = "metrics.json" if pid == 0 else f"metrics.p{pid}.json"
    with open(os.path.join(cfg.output, metrics_name), "w") as f:
        json.dump(metrics, f, indent=2)
    log.info("ALL STAGES COMPLETED IN %ss", metrics["total_s"])
    log.info("OUTPUT: %s", os.path.join(cfg.output, "phased_sv.vcf"))
    return os.path.join(cfg.output, "phased_sv.vcf")
