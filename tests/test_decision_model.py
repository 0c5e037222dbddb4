"""Learned decision layer (flag-gated; the verbatim tree stays default)."""

import json

import numpy as np
import pytest

from duet_tpu.models import decision_model as dm


def test_model_loads_and_contract():
    model = dm.load_model()
    assert model["features"] == list(dm.FEATURE_NAMES)
    assert "tree" in model


def test_predict_matches_manual_traversal():
    model = {"features": list(dm.FEATURE_NAMES), "tree": {
        "feature": 1, "threshold": 0.5,               # sv_ratio
        "left": {"leaf": 0},
        "right": {"feature": 13, "threshold": 5.0,    # sv_num
                  "left": {"leaf": 1}, "right": {"leaf": 2}},
    }}
    X = np.zeros((3, len(dm.FEATURE_NAMES)))
    X[0, 1] = 0.2                 # left -> 0
    X[1, 1], X[1, 13] = 0.8, 3    # right, left -> 1
    X[2, 1], X[2, 13] = 0.9, 9    # right, right -> 2
    assert dm.predict_class(model, X).tolist() == [0, 1, 2]


def test_learned_het_side_follows_evidence():
    from duet_tpu.models.sv_phaser import PhaseFeatures

    n = 3
    z = np.zeros(n)
    f = PhaseFeatures(
        hap1=np.array([3.0, 0.0, 2.0]), hap2=np.array([0.0, 3.0, 2.0]),
        hap0=z, allhap=np.array([3.0, 3.0, 4.0]),
        hap1_totsc=np.array([900.0, 0.0, 500.0]),
        hap2_totsc=np.array([0.0, 900.0, 400.0]),
        hap1_avgsc=np.array([300.0, 0.0, 250.0]),
        hap2_avgsc=np.array([0.0, 300.0, 200.0]),
        ps=np.zeros(n, np.int64), hapread_ratio=np.full(n, 0.5),
        sv_ratio=np.full(n, 0.5), totsc_ratio=z, onehap_totsc=z,
        hap_avgsc_diff=z, ref_num=np.full(n, 3.0), sv_num=np.full(n, 3.0),
    )
    model = {"features": list(dm.FEATURE_NAMES),
             "tree": {"leaf": 1}}      # always het
    pred = dm.decide_haplotype_learned(f, np.ones(n, np.int64), model)
    assert pred.tolist() == [1, 2, 1]  # side = larger PC mass


def test_pipeline_learned_flag(tmp_path):
    """--decision-model learned runs e2e and stays competitive; the default
    path is byte-identical to an explicit verbatim run."""
    from duet_tpu.eval.evaluate import evaluate_files
    from duet_tpu.pipeline import PipelineConfig, run_pipeline
    from duet_tpu.sim import SimConfig, simulate_dataset

    simulate_dataset(str(tmp_path), SimConfig(
        contigs={"chr21": 200_000}, coverage=14.0, seed=88))
    base = dict(bam=str(tmp_path / "reads.bam"),
                reference=str(tmp_path / "ref.fa"), use_device_kernel=False)
    v = run_pipeline(PipelineConfig(output=str(tmp_path / "o_v"),
                                    decision_model="verbatim", **base))
    d = run_pipeline(PipelineConfig(output=str(tmp_path / "o_d"), **base))
    assert open(v, "rb").read() == open(d, "rb").read()
    l = run_pipeline(PipelineConfig(output=str(tmp_path / "o_l"),
                                    decision_model="learned", **base))
    rv = evaluate_files(v, str(tmp_path / "truth.vcf")).summary()
    rl = evaluate_files(l, str(tmp_path / "truth.vcf")).summary()
    assert rl["calling"]["f1"] >= rv["calling"]["f1"] - 0.1


def _row_reaching_leaf(model, target):
    """Construct a feature row that lands on a `target`-class leaf by
    walking the shipped tree and satisfying each comparison; None when no
    such leaf is reachable."""
    def walk(node, bounds):
        if "leaf" in node:
            return bounds if node["leaf"] == target else None
        f, t = node["feature"], node["threshold"]
        lo, hi = bounds.get(f, (-1e12, 1e12))
        if lo <= t:
            got = walk(node["left"], {**bounds, f: (lo, min(hi, t))})
            if got is not None:
                return got
        if hi > t:
            got = walk(node["right"],
                       {**bounds, f: (max(lo, np.nextafter(t, np.inf)), hi)})
            if got is not None:
                return got
        return None

    bounds = walk(model["tree"], {})
    if bounds is None:
        return None
    x = np.zeros(len(dm.FEATURE_NAMES))
    for f, (lo, hi) in bounds.items():
        x[f] = hi if hi < 1e12 else lo
    return x


def test_shipped_tree_is_not_degenerate():
    """Ship-bar: the production tree has depth >= 2,
    a REACHABLE class-0 (filtered) leaf, and at least one magnitude/count
    feature binding — a retrain that regresses to a stump fails here."""
    from duet_tpu.tools.train_decision import tree_stats

    model = dm.load_model()
    depth, feats, classes = tree_stats(model["tree"])
    assert depth >= 2
    assert {0, 1, 2} <= classes
    magnitude = {dm.FEATURE_NAMES.index(f) for f in
                 ("totsc_ratio", "onehap_totsc", "hap_avgsc_diff",
                  "totsc_min", "totsc_max", "ref_num", "sv_num",
                  "hap_min", "hap_max", "hap0", "allhap")}
    assert feats & magnitude


def test_shipped_tree_class0_leaf_exercised():
    """A concrete feature row (derived from the shipped tree's own
    thresholds) actually comes back class 0 through the runtime
    evaluator — the filter is learned, not inherited."""
    model = dm.load_model()
    row = _row_reaching_leaf(model, 0)
    assert row is not None
    assert dm.predict_class(model, row[None, :])[0] == 0
    # and classes 1/2 stay reachable too
    for cls in (1, 2):
        r = _row_reaching_leaf(model, cls)
        assert r is not None
        assert dm.predict_class(model, r[None, :])[0] == cls
