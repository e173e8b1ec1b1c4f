"""est tests: differential vs the reference binary's C windowing (fed by
a smoother shim, since the shipped smooth_GC_mrsfast.py is broken on
numpy >= 1.24 — SURVEY.md Q6/E5), plus analytics unit tests."""

import os
import stat
import subprocess

import numpy as np
import pytest

from quickmer2.analytics import gc_correct
from quickmer2.analytics.lowess import lowess
from quickmer2.config import SearchConfig
from quickmer2.io import formats
from quickmer2.pipelines import count as count_pipe
from quickmer2.pipelines import est as est_pipe
from quickmer2.pipelines import search as search_pipe
from tests import helpers

K = 30

SHIM = """#!/usr/bin/env python3
import sys, struct, os
sys.path.insert(0, {repo!r})
from quickmer2.analytics.gc_correct import factors_from_txt
factors, _ = factors_from_txt(sys.argv[1])
with os.fdopen(sys.stdout.fileno(), "wb", closefd=False) as out:
    out.write(struct.pack("f" * len(factors), *factors.tolist()))
    out.flush()
"""


def _reference_lowess(x, y, f, iters=3):
    """The reference lowess.py's algorithm, point by point: tricube
    weights over the r nearest neighbours, one weighted linear fit per
    point solved with lstsq, bisquare robustifying weights."""
    n = len(x)
    r = int(np.ceil(f * n))
    h = np.array([np.sort(np.abs(x - x[i]))[r] for i in range(n)])
    w = np.clip(np.abs((x[:, None] - x[None, :]) / h), 0.0, 1.0)
    w = (1 - w ** 3) ** 3
    yest = np.zeros(n)
    delta = np.ones(n)
    for _ in range(iters):
        for i in range(n):
            weights = delta * w[:, i]
            b = np.array([np.sum(weights * y), np.sum(weights * y * x)])
            a = np.array([[np.sum(weights), np.sum(weights * x)],
                          [np.sum(weights * x), np.sum(weights * x * x)]])
            beta = np.linalg.lstsq(a, b, rcond=None)[0]
            yest[i] = beta[0] + beta[1] * x[i]
        resid = y - yest
        s = np.median(np.abs(resid))
        delta = np.clip(resid / (6.0 * s), -1, 1)
        delta = (1 - delta ** 2) ** 2
    return yest


def test_lowess_matches_reference_impl(rng):
    """Our closed-form LOWESS vs the reference lowess.py's semantics
    (reimplemented above with a per-point lstsq solve)."""
    x = np.arange(201) / 4.0 + 25.0
    y = 20 + 5 * np.sin(x / 8.0) + rng.normal(0, 0.5, size=201)
    ours = lowess(x, y, f=0.15)
    theirs = _reference_lowess(x, y, f=0.15)
    np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-8)


def test_lowess_degenerate_inputs():
    # Q10: uniform y (median residual 0) must not NaN
    x = np.arange(201, dtype=float)
    y = np.full(201, 7.0)
    out = lowess(x, y, f=0.15)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 7.0, atol=1e-9)


def test_correction_factor_properties(rng):
    mean = 20 + 5 * np.sin(np.arange(401) / 40.0)
    count = np.full(401, 1000)
    f, ave = gc_correct.correction_factors(mean, count)
    assert f.dtype == np.float32
    assert (f >= 1 / 3 - 1e-6).all() and (f <= 3 + 1e-6).all()
    assert abs(ave - mean.mean()) < 1e-6


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, ref_binary):
    """search + count artifacts for est differential testing."""
    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("est")

    def gc_seg(length, gc):
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        return bytes(np.frombuffer(b"ACGT", np.uint8)[
            rng.choice(4, size=length, p=p)]).decode()

    chr1 = "".join(gc_seg(4000, g) for g in
                   [0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65])
    dup = gc_seg(6000, 0.5)
    chr1 = chr1 + dup
    chr2 = gc_seg(3000, 0.5)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t0\t32000\nc2\t0\t3000\n")
    helpers.run_ref(ref_binary,
                    ["search", "-k", str(K), "-t", "1", "-s", "1M", "-e", "0",
                     "-w", "100", "-c", ctrl, "g.fa"], cwd=str(d))
    reads = helpers.simulate_reads(rng, chr1, 20 * len(chr1) // 100, 100)
    reads += helpers.simulate_reads(rng, dup, 2 * 20 * len(dup) // 100, 100)
    reads += helpers.simulate_reads(rng, chr2, 20 * len(chr2) // 100, 100)
    rp = str(d / "reads.fa")
    helpers.write_reads_fasta(rp, reads)
    helpers.run_ref(ref_binary, ["count", "-t", "0", "g.fa", "reads.fa", "smp"],
                    cwd=str(d))
    return {"dir": str(d), "fa": fa, "dup_span": (32000, 38000)}


def test_est_matches_reference_binary(pipeline, ref_binary, tmp_path):
    """Run the reference est with a shim smoother that produces OUR
    correction factors; its C windowing output must match our run_est
    to float tolerance."""
    d = pipeline["dir"]
    shim_dir = str(tmp_path / "bin")
    os.makedirs(shim_dir)
    shim = os.path.join(shim_dir, "smooth_GC_mrsfast.py")
    with open(shim, "w") as f:
        f.write(SHIM.format(repo=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    os.chmod(shim, os.stat(shim).st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=shim_dir + os.pathsep + os.environ["PATH"])
    subprocess.run([ref_binary, "est", "g.fa", "smp", "ref_cn.bed"],
                   cwd=d, env=env, check=True, capture_output=True)

    out = str(tmp_path / "our_cn.bed")
    est_pipe.run_est(pipeline["fa"], os.path.join(d, "smp"), out, verbose=False)

    ref_chroms, ref_vals = formats.read_cn_bed(os.path.join(d, "ref_cn.bed"))
    our_chroms, our_vals = formats.read_cn_bed(out)
    assert our_chroms == ref_chroms
    np.testing.assert_array_equal(our_vals[:, :2], ref_vals[:, :2])
    np.testing.assert_allclose(our_vals[:, 2], ref_vals[:, 2], atol=2e-6)

    # biological sanity: duplicated segment near CN 6, elsewhere near 2
    lo, hi = pipeline["dup_span"]
    is1 = np.array(our_chroms) == "c1"
    cn = our_vals[:, 2]
    in_dup = is1 & (our_vals[:, 0] >= lo) & (our_vals[:, 1] <= hi)
    assert abs(cn[is1 & ~in_dup].mean() - 2.0) < 0.25
    assert abs(cn[in_dup].mean() - 6.0) < 0.8


def test_est_txt_regeneration(pipeline, tmp_path):
    """Deleting .txt exercises our (correct) regeneration path; the CN
    output must be unchanged (the reference's regen path is broken)."""
    import shutil
    d = pipeline["dir"]
    w = str(tmp_path / "w")
    os.makedirs(w)
    for fn in ("g.fa.qgc", "g.fa.bed", "smp.bin", "smp.txt"):
        shutil.copy(os.path.join(d, fn), os.path.join(w, fn))
    out1 = str(tmp_path / "cn1.bed")
    est_pipe.run_est(os.path.join(w, "g.fa"), os.path.join(w, "smp"), out1,
                     verbose=False)
    ref_txt = open(os.path.join(w, "smp.txt")).read()
    os.remove(os.path.join(w, "smp.txt"))
    out2 = str(tmp_path / "cn2.bed")
    est_pipe.run_est(os.path.join(w, "g.fa"), os.path.join(w, "smp"), out2,
                     verbose=False)
    assert open(os.path.join(w, "smp.txt")).read() == ref_txt
    assert open(out1).read() == open(out2).read()


def test_window_sums_precision_at_scale():
    """Segment-sum window accumulation must hold float64-level relative
    accuracy at human scale (the round-1 global float32 cumsum lost all
    precision past ~1e7 k-mers x depth 25; VERDICT Weak #8)."""
    import jax.numpy as jnp
    from quickmer2.ops.est_device import corrected_window_sums

    n = 101_000_000          # > 1e8 k-mers
    w = 1000
    rng2 = np.random.default_rng(5)
    depth = rng2.poisson(25.0, size=n).astype(np.uint32)
    gc = rng2.integers(0, 401, size=n).astype(np.int32)
    factors = np.linspace(0.4, 2.8, 401).astype(np.float32)
    kstarts = np.arange(0, n - w + 1, w, dtype=np.int32)
    kends = kstarts + w

    got = np.asarray(corrected_window_sums(
        jnp.asarray(depth), jnp.asarray(gc), jnp.asarray(factors),
        jnp.asarray(kstarts), jnp.asarray(kends)))

    # float64 ground truth on a sampled set of windows (full f64 pass
    # would dominate test time)
    probe = np.linspace(0, len(kstarts) - 1, 97).astype(int)
    prod = None
    for wi in probe:
        s, e = int(kstarts[wi]), int(kends[wi])
        truth = np.sum(factors[gc[s:e]].astype(np.float64)
                       * depth[s:e].astype(np.float64))
        assert abs(got[wi] - truth) <= 1e-4 * abs(truth), (wi, got[wi], truth)
