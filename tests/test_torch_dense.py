"""Whole-solve parity of the PyTorch port's dense solver with
bibfs_tpu.solvers.dense in all nine modes on small random graphs (the
Pallas modes of the reference run in interpret mode), plus agreement with
the port's own serial oracle."""

import numpy as np
import pytest

from tests.conftest import random_graph_cases

MODES = ["sync", "alt", "beamer", "beamer_alt", "pallas", "pallas_alt",
         "fused", "fused_alt", "sync_unfused"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def assert_same_solve(a, b):
    """Public results equal on everything but the wall clock."""
    assert (a.found, a.hops, a.meet, a.path, a.levels, a.edges_scanned) == (
        b.found, b.hops, b.meet, b.path, b.levels, b.edges_scanned)


def assert_same_raw(oj, ot):
    """Raw kernel outputs ``(best, meet, par_s, par_t, levels, edges)``."""
    assert [int(oj[0]), int(oj[1]), int(oj[4]), int(oj[5])] == [
        ot[0], ot[1], ot[4], ot[5]]
    assert np.array_equal(np.asarray(oj[2]), ot[2].numpy())
    assert np.array_equal(np.asarray(oj[3]), ot[3].numpy())


def compare_graph(n, edges, mode, pairs, layout="ell", unroll=1):
    """Both packages on one graph: the public solve for every pair, and the
    raw outputs of ``_get_kernel`` (for Beamer modes at the reference's cap,
    at cap 0 and at a cap that pushes every level)."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    gj = jd.DeviceGraph.build(n, edges, layout=layout)
    gt = td.DeviceGraph.build(n, edges, layout=layout, device="cpu")
    caps = [jd.kernel_cap(mode, gj.n_pad)]
    if jd.DENSE_MODES[mode][1]:
        caps += [0, gj.n_pad]
    for s, d in pairs:
        a = jd.solve_dense_graph(gj, s, d, mode=mode, unroll=unroll)
        b = td.solve_dense_graph(gt, s, d, mode=mode, unroll=unroll)
        assert_same_solve(a, b)
        for cap in caps:
            kj = jd._get_kernel(mode, cap, gj.tier_meta, jd._geom_of(gj), unroll)
            kt = td._get_kernel(mode, cap, gt.tier_meta, unroll)
            oj = kj(gj.nbr, gj.deg, gj.aux, jd._device_scalar(s),
                    jd._device_scalar(d))
            ot = kt(gt.nbr, gt.deg, gt.aux, s, d, cache=gt.tables)
            assert_same_raw(oj, ot)
    return gt


@pytest.mark.parametrize("mode", MODES)
def test_dense_matches_reference_on_random_graphs(mode):
    for n, edges, src, dst in random_graph_cases(6):
        compare_graph(n, edges, mode, [(src, dst), (dst, src), (0, n - 1)])


def test_default_push_cap_matches_reference_at_small_sizes():
    """The port's uncalibrated Beamer cap equals the reference's cap on
    this box for graphs under 12k rows, so the public Beamer solves above
    compare like with like."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    for n_pad in (8, 120, 512, 4096, 12_000):
        assert td.kernel_cap("beamer", n_pad, "cuda") == jd.kernel_cap("beamer", n_pad)
    assert td.kernel_cap("sync", 4096, "cuda") == 0


@pytest.mark.parametrize("mode", ["beamer", "beamer_alt"])
def test_beamer_matches_reference_above_12k_rows(mode):
    """The port's Beamer cap reads the same calibration block as the
    reference (``cpu`` here), so at 16,384 padded rows, where the
    calibrated and the uncalibrated caps differ (256 against 128) and the
    two caps claim other parents on these pairs, the public solve and the
    raw outputs at each package's own cap are the reference's."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.solvers import dense as td

    n = 16_384
    edges = gnp_random_graph(n, 6.0 / n, seed=4)
    gj = jd.DeviceGraph.build(n, edges)
    gt = td.DeviceGraph.build(n, edges, device="cpu")
    assert gt.n_pad >= 16_384
    kj = jd._get_kernel(mode, jd.kernel_cap(mode, gj.n_pad), gj.tier_meta,
                        jd._geom_of(gj), 1)
    for s, d in ((1, 2), (100, 12_000), (0, n - 1)):
        assert_same_solve(jd.solve_dense_graph(gj, s, d, mode=mode),
                          td.solve_dense_graph(gt, s, d, mode=mode))
        assert_same_raw(kj(gj.nbr, gj.deg, gj.aux, jd._device_scalar(s),
                           jd._device_scalar(d)),
                        td._run(gt, s, d, mode, 1, None))


@pytest.mark.parametrize("n_pad", [12_288, 16_384, 50_000, 100_000, 1 << 20,
                                   1 << 23])
def test_push_cap_matches_reference_from_12k_rows(n_pad):
    """Both packages' Beamer caps agree on the host's platform at sizes
    where the calibrated rule departs from the uncalibrated one."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    for mode in ("beamer", "beamer_alt", "sync"):
        assert td.kernel_cap(mode, n_pad, "cpu") == jd.kernel_cap(mode, n_pad)


def test_push_cap_reads_the_platform_block(tmp_path, monkeypatch):
    """The calibrated branch (rounded down, clamped, 0 = pull only), the
    override file, the refused degraded block and the uncalibrated rule
    for a platform without a block."""
    import json

    from bibfs_tpu_torch.solvers.dense import _auto_push_cap
    from bibfs_tpu_torch.utils import calibrate

    path = tmp_path / "calibration.json"
    monkeypatch.setenv(calibrate.CAL_ENV, str(path))
    try:
        path.write_text(json.dumps({"cuda": {"push_cap": 1024,
                                             "push_cap_divisor": 97}}))
        calibrate.clear_cache()
        assert _auto_push_cap(100_000, "cuda") == 1024  # 1030 rounded down
        assert _auto_push_cap(10 ** 7, "cuda") == 4096
        assert _auto_push_cap(100, "cuda") == 128
        assert _auto_push_cap(100_000, "cpu") == 512  # no cpu block
        path.write_text(json.dumps({"cuda": {"push_cap": 0}}))
        calibrate.clear_cache()
        assert _auto_push_cap(100_000, "cuda") == 0
        path.write_text(json.dumps({"cuda": {"push_cap": 1024,
                                             "push_cap_divisor": 97,
                                             "dispatch_cached_us": 5000.0}}))
        calibrate.clear_cache()
        assert calibrate.load_calibration("cuda") is None
        assert _auto_push_cap(100_000, "cuda") == 512
        path.write_text("{not json")
        calibrate.clear_cache()
        assert _auto_push_cap(100_000, "cuda") == 512
    finally:
        calibrate.clear_cache()


@pytest.mark.parametrize("mode", MODES)
def test_dense_matches_own_oracle(mode):
    from bibfs_tpu_torch.solvers.dense import DeviceGraph, solve_dense_graph
    from bibfs_tpu_torch.solvers.serial import solve_serial

    for n, edges, src, dst in random_graph_cases(20, seed=321):
        want = solve_serial(n, edges, src, dst)
        got = solve_dense_graph(DeviceGraph.build(n, edges, device="cpu"),
                                src, dst, mode=mode)
        assert got.found == want.found and got.hops == want.hops
        got.validate_path(n, edges, src, dst)
        assert got.mode == mode and got.host_syncs >= 1
