"""Benchmark: K1 kernel throughput + end-to-end pipeline on one device.

Prints ONE JSON line, tagged with the device and (on a GPU) the card's name
and power limit:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N, ...}

Measured surfaces
  kernel  the framework's hot inner loop (K1): fused phasing power-iteration
          + per-read haplotype scoring over a dense reads x het-sites window
          (duet_tpu.ops.haplotag.phase_and_tag) — the device replacement
          for WhatsHap haplotag (SURVEY.md §2.2 hot loops).
  e2e     the full pipeline, BAM -> phased_sv.vcf on a simulated dataset
          (the reference's measured unit: per-stage wall-clock in
          run_duet.log, reference duet:21-27), reported under the "e2e" key
          with per-stage seconds and pipeline reads/s.

`vs_baseline` is the device-kernel speedup over the SAME computation in
numpy float32 BLAS on THIS HOST's CPU (single process) — labeled as such in
"baseline"; the reference CPU pipeline itself (WhatsHap/cuteSV) is not
installable in this image (BASELINE.md).

Flags: --quick (small shapes, skip e2e), --e2e (pipeline only),
       --e2e-mb N (dataset megabases, default 2).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def make_batch(R, S, B, density, seed=0):
    rng = np.random.default_rng(seed)
    cov = rng.random((R, S)) < density
    alleles = np.where(cov, rng.choice([-1, 1], size=(R, S)), 0).astype(np.int8)
    weights = np.where(cov, rng.integers(10, 41, (R, S)), 0).astype(np.float32)
    phase0 = rng.choice([-1.0, 1.0], size=S).astype(np.float32)
    block_id = np.sort(rng.integers(0, B, S))
    onehot = np.zeros((S, B), dtype=np.float32)
    onehot[np.arange(S), block_id] = 1.0
    return alleles, weights, phase0, onehot


def host_reference(alleles, weights, phase0, onehot, sweeps=2):
    """Same math in numpy float32 (the CPU baseline)."""
    aw = alleles.astype(np.float32) * weights
    abs_aw = np.abs(aw)
    phase = phase0.copy()
    covered = phase0 != 0
    for _ in range(sweeps):
        signed = aw @ phase
        h = np.sign(signed).astype(np.float32)
        votes = aw.T @ h
        phase = np.where(votes > 0, 1.0, np.where(votes < 0, -1.0, phase))
        phase = np.where(covered, phase, 0.0).astype(np.float32)
    signed = aw @ phase
    rest = abs_aw @ np.concatenate(
        [(phase != 0).astype(np.float32)[:, None], onehot], axis=1
    )
    return signed, rest


def device_info() -> dict:
    """What every number in the output ran on: JAX's device, and on a GPU
    the card's name and power limit as nvidia-smi reports them."""
    import jax

    dev = jax.devices()[0]
    card = None
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def bench_kernel(quick: bool) -> dict:
    import jax

    from duet_tpu.ops.haplotag import phase_and_tag

    R, S, B = (8192, 1024, 16) if quick else (32768, 4096, 64)
    iters = 5 if quick else 20
    batch = make_batch(R, S, B, density=0.05)
    dev_args = [jax.device_put(a) for a in batch]
    iter_stats: dict[str, float] = {}

    def time_dev(fn):
        out = fn()  # compile + warmup
        jax.block_until_ready(jax.tree.leaves(out))
        # headline: pipelined dispatch, one final sync
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(jax.tree.leaves(out))
        mean = (time.perf_counter() - t0) / iters
        # diagnostics: a second, per-iteration-synced loop, whose spread
        # is recorded next to the headline
        ts = []
        for _ in range(min(iters, 8)):
            t0 = time.perf_counter()
            jax.block_until_ready(jax.tree.leaves(fn()))
            ts.append(time.perf_counter() - t0)
        if not iter_stats or mean < iter_stats["iter_mean_s"]:
            iter_stats.update(
                iter_mean_s=mean,
                synced_iter_mean_s=float(np.mean(ts)),
                synced_iter_std_s=float(np.std(ts)),
                synced_iter_min_s=float(np.min(ts)),
                synced_iter_max_s=float(np.max(ts)))
        return mean

    dev_s = time_dev(lambda: phase_and_tag(*dev_args, sweeps=2))
    reads_per_s = R / dev_s

    # host baseline (fewer iters; it is much slower)
    host_reference(*batch)  # warmup / page-in
    h_iters = 1 if quick else 3
    t0 = time.perf_counter()
    for _ in range(h_iters):
        host_reference(*batch)
    host_s = (time.perf_counter() - t0) / h_iters
    return {
        "metric": "haplotag_scoring_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / (R / host_s), 2),
        "baseline": "numpy float32 on this host CPU (same computation, "
                    "single process); the reference CPU pipeline is not "
                    "installable here",
        "kernel_iter_stats": {k: round(v, 6) for k, v in iter_stats.items()},
    }


def bench_e2e(megabases: float, device_stages: str = "auto") -> dict:
    """Simulate ~`megabases` Mb of reads and run the full pipeline on the
    live backend (warm persistent compile cache), reference-style per-stage
    wall-clock + pipeline reads/s.

    device_stages="auto" is the production configuration (size gates route
    small inputs to the host); "on" forces every stage's device kernel
    (sparse COO haplotag route), proving the device path end-to-end with
    honest per-stage dispatch counts."""
    import os
    import tempfile

    import jax

    from duet_tpu.pipeline import PipelineConfig, run_pipeline
    from duet_tpu.sim import SimConfig, simulate_dataset

    n_contigs = max(int(round(megabases)), 1)
    contigs = {f"chr{i + 1}": 1_000_000 for i in range(n_contigs)}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        t0 = time.perf_counter()
        simulate_dataset(data, SimConfig(contigs=contigs, seed=9,
                                         coverage=15.0))
        sim_s = time.perf_counter() - t0
        # two in-process runs: the first pays jit compiles, the second
        # measures steady-state pipeline throughput — the number that
        # matters for a persistent service.  Both are reported.
        totals = {}
        for label in ("cold", "warm"):
            out = os.path.join(tmp, f"out_{label}")
            t0 = time.perf_counter()
            run_pipeline(PipelineConfig(
                bam=os.path.join(data, "reads.bam"),
                reference=os.path.join(data, "ref.fa"),
                output=out, device_stages=device_stages,
            ))
            totals[label] = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.json")) as f:
            m = json.load(f)
        n_calls = sum(
            1 for ln in open(os.path.join(out, "phased_sv.vcf"))
            if ln.strip() and not ln.startswith("#")
        )
        # standalone decoder throughput: the BAM -> packed-columns step in
        # isolation (best of 3), so the e2e
        # ingest share is attributable to the decoder vs everything else
        decode_s = None
        try:
            from duet_tpu.io.native_ingest import load_read_store_native

            bam = os.path.join(data, "reads.bam")
            load_read_store_native(bam)  # warm page cache / .so load
            decode_s = min(
                _timed(lambda: load_read_store_native(bam)) for _ in range(3)
            )
        except Exception as e:
            print(f"# native decoder bench skipped: {e}", file=sys.stderr)
    ingest_s = m["stages"].get("ingest", 0.0)
    result = {
        "backend": jax.default_backend(),
        "device_stages": device_stages,
        "megabases": n_contigs,
        "reads": m["counts"]["reads"],
        "sim_s": round(sim_s, 2),
        "cold_total_s": round(totals["cold"], 2),
        "total_s": round(totals["warm"], 2),
        "reads_per_s": round(m["counts"]["reads"] / totals["warm"], 1),
        "per_stage_s": m["stages"],
        "ingest": m.get("ingest", {}),
        "ingest_share_of_warm": round(ingest_s / totals["warm"], 3),
        "backends": m.get("backends", {}),
        "device_dispatch": m.get("device_dispatch", {}),
        # per-stage transfer/compute/readback seconds from the warm run
        # (utils.devcost): splits e.g. a slow snp_calling into h2d_s vs
        # compute_s in the artifact itself
        "device_cost": m.get("device_cost", {}),
        "phased_calls": n_calls,
    }
    if decode_s is not None:
        result["bam_decoder_standalone_reads_per_s"] = round(
            m["counts"]["reads"] / decode_s, 1)
    return result


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    quick = "--quick" in sys.argv
    e2e_only = "--e2e" in sys.argv
    mb = 2.0
    if "--e2e-mb" in sys.argv:
        mb = float(sys.argv[sys.argv.index("--e2e-mb") + 1])
    stages = "auto"
    if "--device-stages" in sys.argv:
        stages = sys.argv[sys.argv.index("--device-stages") + 1]

    device = device_info()
    if e2e_only:
        e2e = bench_e2e(mb, device_stages=stages)
        print(json.dumps({
            "metric": "pipeline_reads_per_s_per_chip",
            "value": e2e["reads_per_s"],
            "unit": "reads/s",
            "vs_baseline": 0,
            "device": device,
            "e2e": e2e,
        }))
        return 0

    result = bench_kernel(quick)
    result["device"] = device
    if not quick:
        try:
            result["e2e"] = bench_e2e(mb)
        except Exception as e:
            print(f"# e2e bench skipped: {e}", file=sys.stderr)
        try:
            # forced-device configuration: every stage's kernel on the
            # device (auto's size gates keep small inputs on the host);
            # dispatch counts in the block are actual
            result["e2e_forced_device"] = bench_e2e(mb, device_stages="on")
        except Exception as e:
            print(f"# forced-device e2e skipped: {e}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
