"""The PyTorch port's GP surrogate against the JAX package and sklearn: the
covariance kernels, the batched multi-restart fit given the same restart
initial points, sklearn ranking parity (the two parity tests of
tests/test_surrogate.py, on the port), and the SurrogateManager contract."""

import jax
import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.core.genome import all_genomes
from cmoop_audio_processing_torch.surrogate import gp as tgp
from cmoop_audio_processing_torch.surrogate import kernels as tkern
from cmoop_audio_processing_torch.surrogate.manager import (
    SurrogateManager,
    encode_features,
)
from cmoop_audio_processing_tpu.core.config import Constraints
from cmoop_audio_processing_tpu.core.records import make_individual
from cmoop_audio_processing_tpu.surrogate import gp as jgp
from cmoop_audio_processing_tpu.surrogate import kernels as jkern
from cmoop_audio_processing_tpu.surrogate import manager as jmanager

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

FAST_GP = tgp.GPConfig(n_restarts=3, steps=100)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_matches_the_jax_kernel(nu):
    rng = np.random.default_rng(0)
    xa, xb = rng.random((9, 4)).astype(np.float32), rng.random((6, 4)).astype(np.float32)
    got = tkern.matern(torch.as_tensor(xa), torch.as_tensor(xb), 0.7, nu).numpy()
    want = np.asarray(jkern.matern(xa, xb, 0.7, nu))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tkern.matern(torch.as_tensor(xa), torch.as_tensor(xb), 0.7, 3.5)


def test_matern_gradient_is_finite_at_zero_distance():
    x = torch.rand(5, 3, dtype=torch.float32)
    ls = torch.tensor(0.5, requires_grad=True)
    tkern.matern(x, x, ls, 1.5).sum().backward()
    assert torch.isfinite(ls.grad)


def _jax_inits(cfg, keys):
    return jax.tree.map(lambda *leaves: np.stack([np.asarray(a) for a in leaves]),
                        *[jgp._make_inits(cfg, k) for k in keys])


@pytest.mark.parametrize("n,steps", [(18, 80), (30, 200)])
def test_fit_gp_multi_matches_jax_given_the_same_inits(n, steps):
    """Same data, same restart initial points, the same Adam + best-so-far
    scan: the fitted log-hyperparameters agree to 1e-3 and the posterior
    means to 1e-4 of the target's scale. (Both are f32 fits; on a flat NLL
    ridge the two trajectories can part by more, so the targets here are
    well conditioned.)"""
    rng = np.random.default_rng(4)
    x = rng.random((n, 5))
    ys = [np.sin(2 * x[:, 0]), x[:, 1] ** 2 - 0.3 * x[:, 4]]
    jcfg = jgp.GPConfig(n_restarts=3, steps=steps)
    keys = [jax.random.fold_in(jax.random.key(9), i) for i in range(len(ys))]
    want = jgp.fit_gp_multi(x, ys, jcfg, keys)
    got = tgp.fit_gp_multi(x, ys, tgp.GPConfig(n_restarts=3, steps=steps),
                           device="cpu", inits=_jax_inits(jcfg, keys))
    xq = rng.random((7, 5))
    for y, w, g in zip(ys, want, got):
        np.testing.assert_allclose([g.log_c, g.log_l, g.log_n],
                                   [w.log_c, w.log_l, w.log_n], atol=1e-3)
        np.testing.assert_allclose(
            tgp.predict_gp(g, xq, tgp.GPConfig()),
            jgp.predict_gp(w, xq, jgp.GPConfig()), atol=1e-4 * np.std(y))


def test_fit_gp_without_constant_and_noise_matches_jax():
    """The bare-Matern variant (no constant, no white noise): the unused
    hyperparameters get no gradient and keep their initial values."""
    rng = np.random.default_rng(6)
    x = rng.random((12, 3))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    kw = dict(with_constant=False, with_noise=False, n_restarts=2, steps=30)
    key = jax.random.key(3)
    want = jgp.fit_gp(x, y, jgp.GPConfig(**kw), key)
    inits = _jax_inits(jgp.GPConfig(**kw), [key])
    got = tgp.fit_gp_multi(x, [y], tgp.GPConfig(**kw), device="cpu",
                           inits=inits)[0]
    assert (got.log_c, got.log_n) == (0.0, float(np.log(tgp.JITTER)))
    assert got.log_l == pytest.approx(want.log_l, abs=1e-3)


def test_restart_inits_are_seeded_and_bounded():
    cfg = tgp.GPConfig(n_restarts=4)
    a, b, c = (tgp.make_inits(cfg, s) for s in (5, 5, 6))
    lo, hi = cfg.init_bounds
    for k in tgp.PARAMS:
        assert a[k].shape == (5,) and a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
        assert np.all((a[k][1:] >= lo) & (a[k][1:] <= hi))
    assert a["log_l"][0] == cfg.init_log_length


def test_a_gram_that_fails_to_factor_scores_1e10_and_spares_the_others():
    """One restart starts where the Gram overflows f32 (log_c = 100), so its
    Cholesky fails: it gets NLL 1e10 instead of raising, its NaN gradients
    stay in its own entry, and the other restart's fit is the one a fit
    without it gives, bit for bit."""
    rng = np.random.default_rng(2)
    x = rng.random((8, 2))
    y = np.sin(4 * x[:, 0])
    cfg = tgp.GPConfig(n_restarts=1, steps=30)
    x_p, y_p, noise_p = tgp._pad_training(x.astype(np.float32), y.astype(np.float32))
    xd = torch.as_tensor(x_p)
    dist = torch.sqrt(tkern.sqdist(xd, xd) + 1e-30)
    y_d, noise_d = torch.as_tensor(y_p)[None], torch.as_tensor(noise_p)
    params = {"log_c": torch.tensor([[0.0, 100.0]]),
              "log_l": torch.tensor([[0.0, 0.0]]),
              "log_n": torch.tensor([[-1.0, -1.0]])}
    nll = tgp._nll(params, dist, y_d, noise_d, cfg)
    assert nll[0, 1] == 1e10 and float(nll[0, 0]) < 1e10
    both = tgp._fit_restarts(dist, y_d, noise_d, params, cfg)
    alone = tgp._fit_restarts(dist, y_d, noise_d,
                              {k: v[:, :1] for k, v in params.items()}, cfg)
    for k in tgp.PARAMS:
        assert torch.isfinite(both[k]).all()
        torch.testing.assert_close(both[k], alone[k], rtol=0, atol=0)


def test_gp_ranking_parity_with_sklearn():
    """tests/test_surrogate.py::test_gp_ranking_parity_with_sklearn on the
    port: ranking on held-out points tracks sklearn's."""
    from scipy.stats import spearmanr
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import (
        ConstantKernel as C,
        Matern,
        WhiteKernel,
    )

    rng = np.random.default_rng(2)
    x = rng.random((40, 4)) * 2
    y = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] - 0.2 * x[:, 2] ** 2 + 0.05 * rng.standard_normal(40)
    xq = rng.random((30, 4)) * 2

    sk = GaussianProcessRegressor(
        kernel=C(1.0) * Matern(length_scale=1.0, nu=1.5) + WhiteKernel(0.1),
        n_restarts_optimizer=5,
    ).fit(x, y)
    sk_mu = sk.predict(xq)

    gp = tgp.fit_gp(x, y, tgp.GPConfig(n_restarts=5, steps=300), device="cpu")
    mu = tgp.predict_gp(gp, xq, tgp.GPConfig())

    rho = spearmanr(sk_mu, mu).statistic
    assert rho > 0.95, f"ranking diverged: spearman={rho}"
    assert np.max(np.abs(mu - sk_mu)) < 0.35


def test_gp_ranking_parity_on_archive_shaped_data():
    """tests/test_surrogate.py::test_gp_ranking_parity_on_archive_shaped_data
    on the port: the archive's feature layout, near-duplicate rows, an
    accuracy-shaped target."""
    from scipy.stats import spearmanr
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import (
        ConstantKernel as C,
        Matern,
        WhiteKernel,
    )

    from cmoop_audio_processing_torch.engine.evaluator import FakeEvaluator

    rng = np.random.default_rng(5)
    genomes = all_genomes()
    idx = list(rng.choice(288, 40, replace=False)) + [0, 1, 2, 3, 288 - 1,
                                                      288 - 2, 10, 11, 12, 13]
    train_g = [genomes[i] for i in idx]
    held_g = [genomes[i] for i in rng.choice(288, 40, replace=False)]
    fe = FakeEvaluator()
    y = np.array([fe.fitness(g)[0] for g in train_g])
    y = -(y + 0.01 * rng.standard_normal(len(y)))

    x = encode_features(train_g)
    xq = encode_features(held_g)
    mu_y, sd_y = y.mean(), max(y.std(), 1e-12)
    y_n = (y - mu_y) / sd_y

    sk = GaussianProcessRegressor(
        kernel=C(1.0) * Matern(length_scale=1.0, nu=1.5) + WhiteKernel(0.1),
        n_restarts_optimizer=5,
    ).fit(x, y_n)
    sk_mu = sk.predict(xq)

    gp = tgp.fit_gp(x, y_n, tgp.GPConfig(nu=1.5, n_restarts=10), device="cpu")
    mu = tgp.predict_gp(gp, xq, tgp.GPConfig(nu=1.5))

    rho = spearmanr(sk_mu, mu).statistic
    assert rho > 0.9, f"archive-shaped ranking diverged: spearman={rho}"


def test_predict_matches_jax_on_the_same_state():
    """The float64 host posterior and predictions are copies: given one
    fitted state, both packages predict the same means and stds."""
    rng = np.random.default_rng(8)
    x = rng.random((12, 3))
    y = x[:, 0] - x[:, 1] ** 2
    cfg = tgp.GPConfig(n_restarts=2, steps=40)
    st = tgp.fit_gp(x, y, cfg, seed=1, device="cpu")
    jst = jgp._host_posterior(np.asarray(x, np.float32), y.astype(np.float32),
                              jgp.GPConfig(n_restarts=2, steps=40), st.log_c,
                              st.log_l, st.log_n, st.y_mean, st.y_std)
    xq = rng.random((9, 3))
    for a, b in zip(tgp.predict_gp(st, xq, cfg, return_std=True),
                    jgp.predict_gp(jst, xq, jgp.GPConfig(), return_std=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tgp.predict_gps_shared_x([st, st], xq, cfg),
        jgp.predict_gps_shared_x([jst, jst], xq, jgp.GPConfig()))


def _fake_results(genomes, acc_fn):
    cons = Constraints(0.9, 2.5, 0.09)
    return [make_individual(g, acc_fn(g), 1.0 + 0.01 * g["filters"], 0.05, cons)
            for g in genomes]


def test_encode_features_equals_the_jax_packages():
    genomes = all_genomes()[::17]
    np.testing.assert_array_equal(encode_features(genomes),
                                  jmanager.encode_features(genomes))


def test_manager_archive_dedup_keeps_the_last_entry():
    genomes = all_genomes()[:3]
    mgr = SurrogateManager(tgp.GPConfig(n_restarts=2, steps=30), device="cpu")
    mgr.update(genomes, _fake_results(genomes, lambda g: 0.8))
    assert mgr.archive_size == 3
    mgr.update(genomes[:1], _fake_results(genomes[:1], lambda g: 0.95))
    assert mgr.archive_size == 3
    # the re-evaluated genome moved to the end with its newest value
    last = mgr.archive_items()[-1]
    assert last["genome"] == genomes[0]
    assert last["neg_acc"] == pytest.approx(-0.95)
    assert [e["genome"] for e in mgr.archive_items()] == [genomes[1], genomes[2], genomes[0]]


def test_manager_state_round_trips_and_refits_on_load():
    genomes = all_genomes()[::30][:6]
    mgr = SurrogateManager(FAST_GP, seed=4, device="cpu")
    mgr.update(genomes, _fake_results(genomes, lambda g: 0.8 + 0.001 * g["filters"]))
    state = mgr.state_dict()
    # the JAX package's schema
    jmgr = jmanager.SurrogateManager(jgp.GPConfig(n_restarts=3, steps=100), seed=4)
    jmgr.update(genomes, _fake_results(genomes, lambda g: 0.8 + 0.001 * g["filters"]))
    assert state == jmgr.state_dict()
    mgr2 = SurrogateManager(FAST_GP, device="cpu")
    mgr2.load_state_dict(state)
    assert mgr2.is_fitted and mgr2.state_dict() == state
    p1, s1 = mgr.predict(genomes, return_std=True)
    p2, s2 = mgr2.predict(genomes, return_std=True)
    for t in p1:
        np.testing.assert_array_equal(p1[t], p2[t])
        np.testing.assert_array_equal(s1[t], s2[t])
    recs = mgr2.predict_and_structure(genomes)
    assert all(r["CV"] >= 0 and r["predicted"] for r in recs)


def test_manager_refuses_cuda_without_a_gpu_and_predict_before_fit():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SurrogateManager(FAST_GP)
    with pytest.raises(RuntimeError):
        SurrogateManager(FAST_GP, device="cpu").predict(all_genomes()[:1])
