"""Pipeline parity with the device-kernel stage backends forced on.

The production pipeline routes pileup counting and SV clustering through
the jitted device kernels when an accelerator is live (PipelineConfig.
device_stages="auto"); these tests force the device path on the CPU backend
and pin every artifact byte-identical to the host-path run — the contract
that makes the auto dispatch safe on real hardware.
"""

import gzip
import os

import pytest

from duet_tpu.pipeline import PipelineConfig, run_pipeline


def _read(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def test_device_stage_artifacts_match_host(sim_dataset, tmp_path):
    data_dir, _, _ = sim_dataset
    outs = {}
    for mode in ("off", "on"):
        out = str(tmp_path / f"out_{mode}")
        cfg = PipelineConfig(
            bam=os.path.join(data_dir, "reads.bam"),
            reference=os.path.join(data_dir, "ref.fa"),
            output=out,
            device_stages=mode,
        )
        run_pipeline(cfg)
        outs[mode] = out
    for artifact in ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
                     "phased_sv.vcf"):
        a = _read(os.path.join(outs["off"], artifact))
        b = _read(os.path.join(outs["on"], artifact))
        assert a == b, f"device-stage mismatch in {artifact}"
    # the run must actually have produced calls
    final = _read(os.path.join(outs["on"], "phased_sv.vcf")).decode()
    assert sum(1 for ln in final.splitlines()
               if ln and not ln.startswith("#")) > 0


def test_metrics_attribute_backends(sim_dataset, tmp_path):
    import json

    data_dir, _, _ = sim_dataset
    out = str(tmp_path / "out_m")
    cfg = PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out,
        device_stages="on",
    )
    run_pipeline(cfg)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["backends"]["snp_pileup"] == "device"
    assert metrics["backends"]["sv_cluster"] == "device"
    assert metrics["backends"]["haplotag"] == "device"


def test_backend_labels_report_actual_dispatch(sim_dataset, tmp_path):
    """auto mode on a small input: every size gate routes to the host, so
    the labels must say "host" even though device kernels are ENABLED —
    the artifact of record reports what ran, not config intent."""
    import json

    data_dir, _, _ = sim_dataset
    out = str(tmp_path / "out_auto")
    cfg = PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out,
        # defaults: use_device_kernel=True, device_stages="auto"
    )
    run_pipeline(cfg)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    for stage in ("snp_pileup", "sv_cluster", "phase_refine", "haplotag",
                  "sv_decide"):
        assert metrics["backends"][stage] == "host", (
            stage, metrics["backends"])
    # invocation counts are machine-readable and contain no device entries
    for stage, per_backend in metrics["device_dispatch"].items():
        assert set(per_backend) == {"host"}, (stage, per_backend)
        assert all(n > 0 for n in per_backend.values())


def test_forced_device_dispatch_counts_recorded(sim_dataset, tmp_path):
    """--device-stages on: the dispatch counters prove the kernels ran."""
    import json

    data_dir, _, _ = sim_dataset
    out = str(tmp_path / "out_cnt")
    run_pipeline(PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out, device_stages="on",
    ))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    dd = metrics["device_dispatch"]
    assert dd["snp_pileup"].get("device", 0) > 0
    assert dd["sv_cluster"].get("device", 0) > 0
    assert dd["haplotag"].get("device", 0) > 0
    assert dd["phase_refine"].get("device", 0) > 0


@pytest.mark.parametrize("stages", ["auto", "on"])
@pytest.mark.parametrize("live", [False, True])
def test_auto_gates_are_constants(monkeypatch, stages, live):
    """The auto gates are single size constants whether or not an
    accelerator is live, "on" forces the device at any size, and deciding
    them moves no bytes to a device."""
    import jax

    from duet_tpu import pipeline

    def no_transfer(*args, **kwargs):
        raise AssertionError("a gate decision moved data to a device")

    monkeypatch.setattr(jax, "device_put", no_transfer)
    monkeypatch.setattr(pipeline, "_accelerator_live", lambda: live)
    cfg = pipeline.PipelineConfig(bam="x", reference="y", output="z",
                                  device_stages=stages)
    forced = stages == "on"
    assert cfg.phasing_device_min_nnz() == (
        0 if forced else pipeline.PipelineConfig.PHASING_GATE_NNZ)
    sv = cfg.sv_cfg()
    assert sv.device_min_k == (0 if forced else
                               pipeline.PipelineConfig.SV_GATE_K)
    assert sv.device == (forced or live)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (jax reads it itself, so the
    pipeline sets no other); otherwise the cache sits at a fixed path in
    the checkout."""
    import jax

    from duet_tpu import pipeline

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        from_env = str(tmp_path / "from_env")
        jax.config.update("jax_compilation_cache_dir", from_env)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", from_env)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        pipeline._enable_compilation_cache()
        want = from_env if env_set else os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == want
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])


def test_device_cost_attribution_recorded(sim_dataset, tmp_path):
    """Forced-device runs record the per-stage h2d/compute/d2h split
    (utils.devcost) in metrics.json, so a slow device stage is
    attributable from the artifact itself."""
    import json

    data_dir, _, _ = sim_dataset
    out = str(tmp_path / "out_cost")
    run_pipeline(PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out, device_stages="on",
    ))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    cost = metrics["device_cost"]
    for stage in ("snp_pileup", "sv_cluster", "haplotag", "phase_refine",
                  "sv_decide"):
        assert stage in cost, (stage, sorted(cost))
        row = cost[stage]
        assert row["n_dispatch"] > 0
        assert row["h2d_bytes"] > 0
        assert row["n_puts"] > 0
        # timed phases are non-negative and present
        for k in ("h2d_s", "compute_s", "d2h_s", "worst_put_s"):
            assert row[k] >= 0.0
        # every dispatch read something back on these paths
        assert row["d2h_bytes"] > 0
    # host-only auto run on the same tiny input: no device cost rows
    out2 = str(tmp_path / "out_cost_auto")
    run_pipeline(PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out2,
    ))
    with open(os.path.join(out2, "metrics.json")) as f:
        m2 = json.load(f)
    assert m2["device_cost"] == {}
