"""The yardstick's parts: generators, references, the roofline counts, the
request orders and the trace arithmetic."""

import numpy as np
import pytest
import scipy.optimize
import torch

from portbench import roofline, trace
from portbench.kinds._common import instance_order
from portbench.problems import generators as G
from portbench.reference import covsel as ref_covsel
from portbench.reference.tv1d import round_bf16, tv1d_exact

BIG_SEED = 2**31 + 12345


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("seed", [0, BIG_SEED, 2**40 + 3])
def test_generators_repeat_from_the_seed(seed):
    a = G.tv1d_signals(500, 3, _rng(0), _rng(seed))
    assert np.array_equal(a, G.tv1d_signals(500, 3, _rng(0), _rng(seed))) and a.shape == (3, 500)
    assert not np.array_equal(a, G.tv1d_signals(500, 3, _rng(0), _rng(seed + 1)))
    S1 = G.covsel_covariance(30, _rng(0), _rng(seed))
    assert np.array_equal(S1, G.covsel_covariance(30, _rng(0), _rng(seed)))
    assert np.allclose(S1, S1.T) and np.linalg.eigvalsh(S1).min() > 0
    assert not np.array_equal(S1, G.covsel_covariance(30, _rng(0), _rng(seed + 1)))


@pytest.mark.parametrize("family,cfg,instances", [
    ("tv1d", {"n": 400, "structure_seed": 0, "noise_seed": 1}, {"count": 4}),
    ("covsel", {"p": 20, "structure_seed": 0, "samples_seed": 1, "factor_density": 0.01},
     {"count": 10, "min_ratio": 0.1})])
def test_families_repeat_from_the_seed_and_keep_the_work(family, cfg, instances):
    fam = __import__(f"portbench.problems.{family}", fromlist=["generate"])
    a = fam.generate(cfg, instances, _rng(BIG_SEED))
    b = fam.generate(cfg, instances, _rng(BIG_SEED))
    for key in a:
        assert np.array_equal(a[key], b[key])
    others = [fam.generate(cfg, instances, _rng(BIG_SEED + k)) for k in range(1, 9)]
    if family == "tv1d":
        # the seeds' pools are one pool, reordered, reversed or negated
        base = np.sort(np.abs(a["signals"]), axis=None)
        assert any(not np.array_equal(a["signals"], o["signals"]) for o in others)
        for o in others:
            assert np.array_equal(np.sort(np.abs(o["signals"]), axis=None), base)
    else:
        # one S with its variables permuted: the same spectrum and path
        assert any(not np.array_equal(a["S"], o["S"]) for o in others)
        for o in others:
            assert np.allclose(np.linalg.eigvalsh(o["S"]), np.linalg.eigvalsh(a["S"]))
            assert np.allclose(o["lams"], a["lams"])
        assert len(fam.instances(cfg, instances, a)) == 10


def test_tv1d_signal_shape_follows_the_upstream_generator():
    n = 10_000
    b = G.tv1d_signals(n, 1, _rng(0), _rng(1))[0]
    # piecewise constant (sqrt(n)/2 intervals, each a pair of jumps) plus unit noise
    assert np.std(np.diff(b)) == pytest.approx(np.sqrt(2), rel=0.2)
    assert G.tv1d_weight(n) == 100.0


def test_lambda_path_is_the_huge_default():
    path = G.lambda_path(2.0, 10, 0.1)
    assert path[0] == 2.0 and path[-1] == pytest.approx(0.2)
    assert np.allclose(path[1:] / path[:-1], 0.1 ** (1 / 9))
    S = np.array([[2.0, -0.7, 0.1], [-0.7, 1.0, 0.3], [0.1, 0.3, 1.0]])
    assert G.covsel_lambda_max(S) == 0.7


def _tv1d_by_dual(v, lam):
    """argmin 1/2||x - v||^2 + lam tv(x) from its dual, a box-constrained
    least squares: x = v - D^T z, |z| <= lam."""
    n = v.size
    if n == 1:
        return v.copy()
    D = np.diff(np.eye(n), axis=0)
    res = scipy.optimize.lsq_linear(D.T, v, bounds=(-lam, lam), tol=1e-14, method="bvls")
    return v - D.T @ res.x


@pytest.mark.parametrize("n,lam", [(1, 0.3), (2, 0.1), (2, 5.0), (7, 0.5), (40, 1.3), (40, 100.0)])
def test_tv1d_reference_is_exact(n, lam):
    v = np.random.default_rng(n).standard_normal(n) * 2
    x = tv1d_exact(v, lam)
    assert np.allclose(x, _tv1d_by_dual(v, lam), atol=1e-9)
    if lam >= np.abs(np.cumsum(v - v.mean())).max():
        assert np.allclose(x, v.mean())


def test_bf16_rounding():
    assert round_bf16(1.0) == 1.0 and round_bf16(0.0) == 0.0
    assert round_bf16(1.0 + 2**-9) == 1.0          # a tie goes to even
    assert round_bf16(1.0 + 3 * 2**-9) == 1.0 + 2**-7
    assert round_bf16(-3.14159) == -3.140625
    x = np.random.default_rng(0).standard_normal(1000) * 100
    r = np.array([round_bf16(t) for t in x])
    assert np.all(np.abs(r - x) <= np.abs(x) * 2**-8)
    assert np.array_equal(r, torch.tensor(x, dtype=torch.bfloat16).double().numpy())


def test_tv1d_control_departs_from_the_reference():
    v = G.tv1d_signals(3000, 1, _rng(0), _rng(2))[0]
    lam = G.tv1d_weight(3000)
    exact, low = tv1d_exact(v, lam), tv1d_exact(v, lam, round_bf16)
    assert np.linalg.norm(low - exact) / np.linalg.norm(exact) > 1e-2


def _glasso_2x2(S, lam):
    """p = 2 in closed form: Sigma = Theta^-1 keeps S's diagonal, and its
    off-diagonal entry is S_12 shrunk by lam."""
    s = np.sign(S[0, 1]) * max(abs(S[0, 1]) - lam, 0.0)
    return np.linalg.inv(np.array([[S[0, 0], s], [s, S[1, 1]]]))


@pytest.mark.parametrize("lam", [0.05, 0.3, 0.9])
def test_glasso_reference_2x2(lam):
    S = torch.tensor([[1.3, 0.6], [0.6, 0.8]], dtype=torch.float64)
    W = 1.0 - torch.eye(2, dtype=torch.float64)
    res = ref_covsel.glasso(S, W, lam, gap_tol=1e-14)
    # the objective is quadratic about its minimum: a gap of 1e-14 leaves
    # Theta some 1e-7 off
    assert np.allclose(res.theta.numpy(), _glasso_2x2(S.numpy(), lam), atol=1e-6)
    assert res.primal - res.dual <= 1e-14 * abs(res.primal) + 1e-15


def test_glasso_reference_at_lambda_max_is_diagonal():
    S_np = G.covsel_covariance(25, _rng(0), _rng(4))
    S = torch.tensor(S_np)
    W = 1.0 - torch.eye(25, dtype=torch.float64)
    res = ref_covsel.glasso(S, W, G.covsel_lambda_max(S_np) * 1.01)
    assert np.allclose(res.theta.numpy(), np.diag(1.0 / np.diag(S_np)), atol=1e-7)


def test_glasso_reference_certifies_its_answer():
    S_np = G.covsel_covariance(30, _rng(0), _rng(5))
    lam = 0.3 * G.covsel_lambda_max(S_np)
    S, W = torch.tensor(S_np), 1.0 - torch.eye(30, dtype=torch.float64)
    res = ref_covsel.glasso(S, W, lam)
    assert res.primal - res.dual <= 1e-9 * abs(res.primal)
    # the objective is convex: moving off the answer only raises it
    theta = res.theta
    rng = np.random.default_rng(0)
    for _ in range(5):
        d = torch.tensor(rng.standard_normal((30, 30))) * 1e-3
        assert ref_covsel.objective(S, W, lam, theta + d + d.T) >= res.primal - 1e-9
    # a dual point's value never exceeds a primal value
    assert res.dual <= res.primal


def test_tv1d_prox_work_from_shapes():
    n_bytes, ops = roofline.tv1d_prox_work(10**6, "float32")
    assert n_bytes == 8 * 10**6 and ops == 6 * 10**6
    assert roofline.tv1d_prox_work(10, "float64") == (160, 60)
    # bandwidth bounds the prox: 8 MB at 3.35 TB/s
    assert roofline.bound_s(n_bytes, ops, "float32") == pytest.approx(8e6 / 3.35e12)
    assert roofline.bound_s(0, 67e12, "float32") == pytest.approx(1.0)


def test_k7_kernel_names():
    k = roofline.K7_KERNELS
    assert roofline.is_kernel("void (anonymous namespace)::pdas_tiles<float>("
                              "(anonymous namespace)::Pdas<float>)", k)
    assert roofline.is_kernel("pdas_levels<double>(Pdas<double>)", k)
    assert not roofline.is_kernel("void my_pdas_tiles<float>()", k)
    assert not roofline.is_kernel("aten::add", k)


def test_instance_orders():
    assert [instance_order("cycle", 3, i) for i in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    assert [instance_order("cycle", 1, i) for i in range(3)] == [0, 0, 0]
    with pytest.raises(ValueError):
        instance_order("random", 3, 0)
    with pytest.raises(ValueError):
        instance_order("bounce", 3, 0)


def _trace():
    E = trace.Event
    device = [E("k1", 10, 20), E("k2", 15, 30), E("k1", 50, 60), E("k3", 95, 120)]
    host = [E("portbench.solve", 0, 100), E("aten::eigh", 25, 45), E("aten::eigh", 26, 44),
            E("cudaStreamSynchronize", 40, 45), E("cudaStreamSynchronize", 70, 72)]
    return trace.Trace((0.0, 100.0), device, host)


def test_trace_union_gaps_and_names():
    t = _trace()
    assert t.busy_intervals() == [(10, 30), (50, 60), (95, 100)]
    assert t.busy_s == pytest.approx(35e-6) and t.window_s == pytest.approx(100e-6)
    assert t.idle_gaps() == [(0, 10), (30, 50), (60, 95)]
    assert t.host_at(42) == "cudaStreamSynchronize" and t.host_at(35) == "aten::eigh"
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert [g[0] for g in b["idle_gaps"]] == ["portbench.solve", "cudaStreamSynchronize", "portbench.solve"]
    assert b["idle_gaps"][0][1] == pytest.approx(35e-6)
    assert t.device_time_s(lambda n: n == "k1") == (pytest.approx(20e-6), 2)
    assert t.host_count(trace.HOST_BLOCKING) == 2
    # the device was busy for 5 us of aten::eigh's 25-45
    assert t.busy_during_s("aten::eigh") == (pytest.approx(5e-6), 1)
    assert t.busy_during_s("portbench.solve") == (pytest.approx(35e-6), 1)
    assert t.busy_during_s("cudaStreamSynchronize") == (pytest.approx(0.0), 2)
