"""Smoke test of duet_tpu on NVIDIA GPUs, through the entry points a user
calls (duet_tpu.cli.main), on a chromosome-sized simulated dataset.

    python chip_smoke.py           # one GPU, phases 1-8 below
    python chip_smoke.py --multi   # four GPUs: single-card vs --mesh 2,2/1,4

Phases, in one process (a JAX process reserves most of a card's memory, so
a second one could not share it):

  1 device check     JAX's first device must be a GPU; the card's name and
                     power limit tag every number printed after it
  2 native ingest    build native/libduet_ingest.so from its source; every
                     run below must report ingest.backend == "native"
  3 data             one contig of GRCh38 chr21's length at 10x, ONT-shaped
                     reads, fixed seed
  4 forced device    --device-stages on, cold then warm: every device stage
                     must report backend "device"
  5 host reference   --host-kernel: artifacts byte-identical to phase 4
                     (every device sum is an exact integer)
  6 auto             default flags: artifacts byte-identical to phase 5
  7 NN SNP forward   jitted nn_snp.apply vs apply_np on 2^20 rows, then the
                     nn pipeline on the device vs --host-kernel, byte-equal
  8 K1 dense scoring ops.haplotag.phase_and_tag at 32768x4096x64 against
                     the numpy oracle, with its compiled memory and time

With --multi only the mesh path runs: --device-stages on single-card, then
--mesh 2,2 and --mesh 1,4, artifacts byte-identical to the single-card run.

Any failure exits non-zero and prints no result.  The last line of standard
output is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONTIG = "chr21"
CONTIG_BP = 46_709_983   # GRCh38 chr21
COVERAGE = 10.0
SEED = 21
ARTIFACTS = ("phased_sv.vcf", "snp_calling/pileup.vcf.gz",
             "sv_calling/variants.vcf", f"snp_phasing/phased_{CONTIG}.vcf.gz",
             f"snp_phasing/{CONTIG}.haplotags.tsv")
DEVICE_STAGES = ("snp_pileup", "sv_cluster", "phase_refine", "haplotag",
                 "sv_decide")
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet, SXM


class Reporter:
    """Prints one line per measurement, tagged with the card it ran on."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **values) -> None:
        print(f"[{phase}] {json.dumps(values)} @ {self.card}", flush=True)


def device_check(min_count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU, JAX's first device is "
                 f"{devs[0].platform!r}")
    if len(devs) < min_count:
        sys.exit(f"chip_smoke: needs {min_count} GPUs, JAX sees {len(devs)}")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(cards, flush=True)
    say = Reporter(cards.splitlines()[0])
    say("1 device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), jax=jax.__version__)
    return devs, say


def build_native(say) -> None:
    t0 = time.perf_counter()
    out = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                         check=True, capture_output=True, text=True).stdout
    print(out.strip(), flush=True)
    say("2 native build", seconds=time.perf_counter() - t0)


def simulate(say, data: str) -> None:
    from duet_tpu.sim import SimConfig, simulate_dataset

    t0 = time.perf_counter()
    simulate_dataset(data, SimConfig(contigs={CONTIG: CONTIG_BP}, seed=SEED,
                                     coverage=COVERAGE))
    say("3 data", contig=CONTIG, bp=CONTIG_BP, coverage=COVERAGE, seed=SEED,
        host_seconds=time.perf_counter() - t0)


def run_cli(data: str, out: str, *flags: str):
    """One pipeline run through the CLI: (seconds, metrics)."""
    from duet_tpu.cli import main

    t0 = time.perf_counter()
    rc = main([os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa"),
               out, *flags])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(flags)} exited {rc}")
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    if metrics["ingest"]["backend"] != "native":
        raise RuntimeError(f"ingest backend is {metrics['ingest']['backend']}"
                           ", not native")
    return seconds, metrics


def assert_same_artifacts(ref: str, other: str, label: str) -> None:
    differ = []
    for name in ARTIFACTS:
        with open(os.path.join(ref, name), "rb") as a, \
                open(os.path.join(other, name), "rb") as b:
            if a.read() != b.read():
                differ.append(name)
    if differ:
        raise AssertionError(f"{label}: artifacts differ: {differ}")


def forced_device(say, data: str, tmp: str, dev) -> str:
    cold, _ = run_cli(data, os.path.join(tmp, "dev_cold"),
                      "--device-stages", "on")
    out = os.path.join(tmp, "dev_warm")
    warm, m = run_cli(data, out, "--device-stages", "on")
    for stage in DEVICE_STAGES:
        n = m["device_dispatch"].get(stage, {}).get("device", 0)
        if m["backends"][stage] != "device" or n <= 0:
            raise AssertionError(f"forced run: {stage} ran on "
                                 f"{m['backends'][stage]} ({n} dispatches)")
    say("4 forced device", reads=m["counts"]["reads"], cold_seconds=cold,
        warm_seconds=warm, stages=m["stages"], backends=m["backends"],
        peak_bytes_in_use=dev.memory_stats()["peak_bytes_in_use"])
    return out


def host_reference(say, data: str, tmp: str, device_out: str) -> str:
    out = os.path.join(tmp, "host")
    seconds, m = run_cli(data, out, "--host-kernel")
    assert_same_artifacts(device_out, out, "host-kernel vs forced device")
    say("5 host reference", seconds=seconds, stages=m["stages"],
        artifacts_equal=list(ARTIFACTS))
    return out


def auto(say, data: str, tmp: str, host_out: str) -> None:
    cold, _ = run_cli(data, os.path.join(tmp, "auto_cold"))
    out = os.path.join(tmp, "auto_warm")
    warm, m = run_cli(data, out)
    assert_same_artifacts(host_out, out, "auto vs host-kernel")
    say("6 auto", cold_seconds=cold, warm_seconds=warm, stages=m["stages"],
        backends=m["backends"], gates=m.get("device_size_gates"))


def nn_forward(say, data: str, tmp: str) -> None:
    import jax
    import numpy as np

    from duet_tpu.models import nn_snp

    params = nn_snp.load_params()
    x = np.random.default_rng(SEED).random((1 << 20, nn_snp.N_FEATURES),
                                           dtype=np.float32)
    got = np.asarray(jax.jit(nn_snp.apply)(params, x))
    want = nn_snp.apply_np(params, x)
    argmax_diff = int((got.argmax(1) != want.argmax(1)).sum())
    say("7 nn forward", rows=len(x), max_abs_err=float(np.abs(got - want).max()),
        argmax_mismatches=argmax_diff)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if argmax_diff:
        raise AssertionError(f"nn argmax differs on {argmax_diff} rows")
    dev_out = os.path.join(tmp, "nn_dev")
    host_out = os.path.join(tmp, "nn_host")
    dev_s, m = run_cli(data, dev_out, "--snp-model", "nn",
                       "--device-stages", "on")
    host_s, _ = run_cli(data, host_out, "--snp-model", "nn", "--host-kernel")
    assert_same_artifacts(host_out, dev_out, "nn device vs host-kernel")
    say("7 nn pipeline", device_seconds=dev_s, host_kernel_seconds=host_s,
        backends=m["backends"], snp_sites=m["counts"]["snp_sites"])


def k1_dense(say, dev_kind: str, R: int = 32768, S: int = 4096, B: int = 64,
             sweeps: int = 2, iters: int = 20) -> None:
    import jax
    import numpy as np

    from bench import host_reference as k1_reference
    from bench import make_batch
    from duet_tpu.ops.haplotag import PC_MAX, PC_PER_MARGIN, phase_and_tag

    batch = make_batch(R, S, B, density=0.05)
    args = [jax.device_put(a) for a in batch]
    compiled = phase_and_tag.lower(*args, sweeps=sweeps).compile()
    mem = compiled.memory_analysis()
    out = compiled(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)

    signed, rest = k1_reference(*batch, sweeps=sweeps)
    total, blockw = rest[:, 0], rest[:, 1:]
    tagged = (total > 0) & (signed != 0)
    hap = np.where(tagged, np.where(signed > 0, 1, 2), 0)
    pc = np.clip(np.rint(PC_PER_MARGIN * np.abs(signed)), 1, PC_MAX)
    np.testing.assert_array_equal(np.asarray(out["hap"]), hap)
    np.testing.assert_array_equal(np.asarray(out["best_block"]),
                                  blockw.argmax(axis=1))
    np.testing.assert_array_equal(np.asarray(out["pc"])[tagged], pc[tagged])

    mean = float(np.mean(times))
    nbytes = sum(a.nbytes for a in batch[:2])  # int8 alleles + f32 weights
    peak = HBM_BYTES_PER_S.get(dev_kind)
    say("8 k1 dense", shape=[R, S, B], sweeps=sweeps, iters=iters,
        mean_seconds=mean, min_seconds=min(times), input_bytes=nbytes,
        bytes_per_s=nbytes / mean,
        hbm_share=None if peak is None else nbytes / mean / peak,
        reads_per_s=R / mean, tagged=int(tagged.sum()),
        memory_analysis={k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")})


def mesh_runs(say, data: str, tmp: str) -> None:
    ref = None
    for label, flags in (("single", ()), ("mesh 2,2", ("--mesh", "2,2")),
                         ("mesh 1,4", ("--mesh", "1,4"))):
        name = label.replace(" ", "_").replace(",", "x")
        cold, _ = run_cli(data, os.path.join(tmp, name + "_cold"),
                          "--device-stages", "on", *flags)
        out = os.path.join(tmp, name)
        warm, m = run_cli(data, out, "--device-stages", "on", *flags)
        if ref is None:
            ref = out
        else:
            assert_same_artifacts(ref, out, f"{label} vs single-card")
        say(f"multi {label}", cold_seconds=cold, warm_seconds=warm,
            stages=m["stages"], backends=m["backends"],
            byte_identical_to_single=None if ref == out else True)
    if m["backends"]["snp_pileup"] != "mesh":
        raise AssertionError("mesh 1,4: the pileup did not shard "
                             f"({m['backends']['snp_pileup']})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: compare --mesh 2,2 and --mesh 1,4 with "
                         "the single-card run, and nothing else")
    args = ap.parse_args()
    devs, say = device_check(4 if args.multi else 1)
    build_native(say)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        simulate(say, data)
        if args.multi:
            mesh_runs(say, data, tmp)
        else:
            dev_out = forced_device(say, data, tmp, devs[0])
            host_out = host_reference(say, data, tmp, dev_out)
            auto(say, data, tmp, host_out)
            nn_forward(say, data, tmp)
            k1_dense(say, devs[0].device_kind)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
