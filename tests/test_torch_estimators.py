"""The port's classical estimators (``toolkit/estimators/``) against the JAX
package's, on the CPU, at small seeded sizes (blobs of 240 rows, 5
features, 3 classes, as ``tests/test_toolkit.py`` makes them):

- every registered class fitted on both sides from the same inputs.
  Trees, forests and gradient boosting are host numpy on both sides:
  their flat arrays (``feature``, ``threshold``, ``left``, ``right``,
  ``leaf_value``) must be equal array for array, and so must their
  predictions.  Naive Bayes, kNN and KMeans: predictions and labels
  equal.  The iterative solvers (logistic regression, SGD, the SVMs)
  iterate in f32 on both sides but fuse differently (one XLA program
  against op-by-op torch): predictions equal, fitted coefficients within
  ``COEF_RTOL`` of their largest.  ``SVC``'s random feature map is the
  JAX package's ``jax.random`` draw carried through
  ``convert.carry_estimator`` (torch cannot draw threefry's bits);
- each fitted JAX estimator's state carried into a fresh port estimator
  through ``convert.carry_estimator``: the same predictions (or
  transform) from the same state;
- t-SNE: the embedding after 10 steps within 1e-4 of its scale; the full
  500 steps held by the KL divergence of the embedding, not by
  coordinates, at learning rate 20.  At the default rate (200) and a few
  hundred points the reference's updates are unstable (the exaggerated
  attraction times the rate exceeds 2), so one ulp of input moves the
  final KL by up to 35 % on either side; at rate 20 the two sides' KL
  agree within ``KL_RTOL``;
- ``tests/test_toolkit.py``'s cases on the port: alias resolution,
  init/method validation, blob accuracy, ``predict_proba`` shape, exact
  ``LinearRegression``, KMeans purity, orthogonal PCA, scalers, the SVM
  cases with string labels;
- persistence: a fitted estimator through ``VolumeStorage``: the pickle
  holds CPU tensors only, and the loaded estimator predicts the same.

The kNN data has no tied distances (continuous features): ``jax.lax.
top_k`` and ``torch.topk`` may order ties differently.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.toolkit import registry as jax_registry
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.estimators.decomposition import (
    kl_divergence,
)

COEF_RTOL = 1e-5
KL_RTOL = 2e-2
N, D, K = 240, 5, 3

# (module path, class, constructor kwargs, data, method): the 19 classes.
CASES = [
    ("sklearn.preprocessing", "StandardScaler", {}, "x", "fit_transform"),
    ("sklearn.preprocessing", "MinMaxScaler", {}, "x", "fit_transform"),
    ("sklearn.preprocessing", "OneHotEncoder", {}, "cat", "fit_transform"),
    ("sklearn.linear_model", "LinearRegression", {}, "reg", "fit"),
    ("sklearn.linear_model", "Ridge", {"alpha": 0.5}, "reg", "fit"),
    ("sklearn.linear_model", "LogisticRegression", {}, "clf", "fit"),
    ("sklearn.linear_model", "SGDClassifier", {}, "clf", "fit"),
    ("sklearn.naive_bayes", "GaussianNB", {}, "clf", "fit"),
    ("sklearn.naive_bayes", "MultinomialNB", {}, "counts", "fit"),
    ("sklearn.tree", "DecisionTreeClassifier", {}, "clf", "fit"),
    ("sklearn.ensemble", "RandomForestClassifier",
     {"n_estimators": 12, "max_depth": 6}, "clf", "fit"),
    ("sklearn.ensemble", "GradientBoostingClassifier",
     {"n_estimators": 8, "max_depth": 3}, "clf", "fit"),
    ("sklearn.tree", "DecisionTreeRegressor", {}, "reg", "fit"),
    ("sklearn.neighbors", "KNeighborsClassifier", {}, "clf", "fit"),
    ("sklearn.svm", "LinearSVC", {}, "clf", "fit"),
    ("sklearn.svm", "SVC", {"n_components": 64}, "clf", "fit"),
    ("sklearn.cluster", "KMeans", {"n_clusters": 3}, "x", "fit"),
    ("sklearn.decomposition", "PCA", {"n_components": 2}, "x", "fit"),
    ("sklearn.manifold", "TSNE", {"n_iter": 10}, "x", "fit_transform"),
]
IDS = [c[1] for c in CASES]
TREES = {"DecisionTreeClassifier", "DecisionTreeRegressor"}
FORESTS = {"RandomForestClassifier", "GradientBoostingClassifier"}
SOLVED = {"LogisticRegression", "SGDClassifier", "LinearSVC", "SVC"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    centers = rng.normal(0.0, 3.0, (K, D))
    y = rng.integers(0, K, N)
    x = (centers[y] + rng.normal(0.0, 1.0, (N, D))).astype(np.float32)
    return {
        "x": (x,),
        "cat": (np.stack([y, rng.integers(0, 4, N)], 1),),
        "reg": (x, (x @ np.arange(1, D + 1) + y).astype(np.float32)),
        "clf": (x, y),
        "counts": (rng.poisson(2.0 + y[:, None], (N, D)).astype(np.float32),
                   y),
        "test": x[::4] + np.float32(0.25),
    }


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _jax_state(est) -> dict:
    """A fitted JAX estimator's attributes as numpy (the carry's input)."""
    out = {}
    for key, val in vars(est).items():
        if key == "_tree" and val is not None:
            val = tuple(np.asarray(a) for a in val.stacked()) + (
                val.max_depth,)
        elif isinstance(val, tuple):
            val = tuple(np.asarray(a) for a in val)
        elif isinstance(val, jnp.ndarray):
            val = np.asarray(val)
        out[key] = val
    return out


@pytest.fixture(scope="module")
def jax_fits(data):
    """class -> (fitted JAX estimator, its method's result), fitted once."""
    out = {}
    for mod, cls, kwargs, kind, method in CASES:
        est = jax_registry.resolve(mod, cls)(**kwargs)
        out[cls] = est, getattr(est, method)(*data[kind])
    return out


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _same_answers(got, want):
    """Labels equal; float answers within 1e-5 of their largest."""
    if np.asarray(want).dtype.kind == "f":
        assert _rel(want, got) <= 1e-5
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def _outputs(est, cls, data):
    """What a fitted estimator answers on the test rows."""
    x = data["cat"][0][::4] if cls == "OneHotEncoder" else (
        data["counts"][0][::4] if cls == "MultinomialNB" else data["test"])
    if hasattr(est, "predict"):
        return est.predict(x)
    return est.transform(x)


@pytest.mark.parametrize("mod,cls,kwargs,kind,method", CASES, ids=IDS)
def test_fit_matches_the_jax_package(mod, cls, kwargs, kind, method, data,
                                     jax_fits):
    jest, jout = jax_fits[cls]
    pest = registry.resolve(mod, cls)(**kwargs, device="cpu")
    if cls == "SVC":
        convert.carry_estimator(pest, {"_w": np.asarray(jest._w),
                                       "_b": np.asarray(jest._b)})
    pout = getattr(pest, method)(*data[kind])
    if cls == "TSNE":
        assert np.abs(_np(jout) - _np(pout)).max() <= \
            1e-4 * np.abs(_np(jout)).max()
        return
    if method == "fit_transform":
        _same_answers(pout, jout)
        return
    if cls in TREES:
        for field in ("feature", "threshold", "left", "right",
                      "leaf_value"):
            np.testing.assert_array_equal(
                _np(getattr(pest._tree, field)),
                _np(getattr(jest._tree, field)), err_msg=field)
    if cls in FORESTS:
        for got, want in zip(pest._stacked, jest._stacked):
            np.testing.assert_array_equal(_np(got), _np(want))
    if cls in SOLVED or cls in ("LinearRegression", "Ridge"):
        assert _rel(jest.coef_, pest.coef_) <= COEF_RTOL
    if cls == "GaussianNB":
        assert _rel(jest.theta_, pest.theta_) <= 1e-6
        # var = E[x^2] - mean^2 cancels: f32 summation order shows.
        assert _rel(jest.var_, pest.var_) <= 1e-4
    if cls == "KMeans":
        np.testing.assert_array_equal(pest.labels_, jest.labels_)
        np.testing.assert_allclose(_np(pest.cluster_centers_),
                                   _np(jest.cluster_centers_), atol=1e-5)
    if cls == "PCA":
        # Singular vectors are defined up to sign, per component.
        got, want = _np(pest.components_), _np(jest.components_)
        got = got * np.sign((got * want).sum(1, keepdims=True))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(_np(pest.explained_variance_ratio_),
                                   _np(jest.explained_variance_ratio_),
                                   rtol=1e-5)
        return
    _same_answers(_outputs(pest, cls, data), _outputs(jest, cls, data))
    if hasattr(jest, "predict_proba"):
        np.testing.assert_allclose(_np(pest.predict_proba(data["test"])),
                                   _np(jest.predict_proba(data["test"])),
                                   atol=1e-5)


@pytest.mark.parametrize("mod,cls,kwargs,kind,method",
                         [c for c in CASES if c[1] != "TSNE"],
                         ids=[i for i in IDS if i != "TSNE"])
def test_carried_state_answers_the_same(mod, cls, kwargs, kind, method, data,
                                        jax_fits):
    jest, _ = jax_fits[cls]
    pest = convert.carry_estimator(
        registry.resolve(mod, cls)(**kwargs, device="cpu"), _jax_state(jest))
    _same_answers(_outputs(pest, cls, data), _outputs(jest, cls, data))


def test_tsne_full_run_kl_agrees(data):
    from learningorchestra_tpu.toolkit.estimators.decomposition import (
        TSNE as JaxTSNE,
    )

    x = data["x"][0]
    want = _np(JaxTSNE(learning_rate=20.0).fit_transform(x))
    est = registry.resolve("sklearn.manifold", "TSNE")(
        learning_rate=20.0, device="cpu")
    got = est.fit_transform(x)
    assert got.shape == (N, 2) and torch.isfinite(got).all()
    want_kl = kl_divergence(est.affinities(x), torch.tensor(want))
    assert abs(est.kl_divergence_ - want_kl) <= KL_RTOL * want_kl


# -- tests/test_toolkit.py's cases, on the port ------------------------------


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(42)
    centers = np.array([[0, 0, 0], [4, 4, 0], [0, 4, 4]])
    x = np.concatenate(
        [rng.normal(c, 1.0, size=(100, 3)) for c in centers]
    ).astype(np.float32)
    return x, np.repeat(np.arange(3), 100)


@pytest.mark.parametrize("module_path", [
    "sklearn.linear_model", "learningorchestra_tpu.toolkit.estimators.linear",
    "learningorchestra_tpu_torch.toolkit.estimators.linear",
])
def test_module_paths_resolve_to_the_port(module_path, blobs):
    x, y = blobs
    factory = registry.resolve(module_path, "LogisticRegression")
    assert factory.__module__.startswith("learningorchestra_tpu_torch.")
    assert factory(max_iter=100, device="cpu").fit(x, y).score(x, y) > 0.9


def test_every_jax_estimator_class_resolves_on_the_port():
    """All 19: the JAX package's own paths and their sklearn aliases."""
    jax_classes = [(d["modulePath"], d["class"])
                   for d in jax_registry.list_registered()
                   if ".toolkit.estimators." in d["modulePath"]]
    assert len(jax_classes) == 19
    for mod, cls in jax_classes:
        assert registry.resolve(mod, cls).__module__ == mod.replace(
            "learningorchestra_tpu.", "learningorchestra_tpu_torch.")
    for alias, native in jax_registry.MODULE_ALIASES.items():
        if alias.startswith("sklearn."):
            assert registry.MODULE_ALIASES[alias] == (native.replace(
                "learningorchestra_tpu.", "learningorchestra_tpu_torch."),)
    with pytest.raises(registry.RegistryError):
        registry.resolve("sklearn.linear_model", "NopeClassifier")


def test_validate_init_and_method_params():
    assert registry.validate_init_params(
        "sklearn.linear_model", "LogisticRegression",
        {"max_iter": 10, "bogus_arg": 1, "device": "cpu"}) == [
            "bogus_arg", "device"]  # the device is the server's to set
    factory = registry.resolve("sklearn.linear_model", "LogisticRegression")
    assert registry.validate_method(factory, "fit")
    assert not registry.validate_method(factory, "levitate")
    assert registry.validate_method_params(factory, "fit",
                                           {"x": 1, "zz": 2}) == ["zz"]


@pytest.mark.parametrize("module,cls,kwargs", [
    ("sklearn.linear_model", "LogisticRegression", {"max_iter": 100}),
    ("sklearn.tree", "DecisionTreeClassifier", {"max_depth": 6}),
    ("sklearn.ensemble", "RandomForestClassifier",
     {"n_estimators": 15, "max_depth": 6}),
    ("sklearn.ensemble", "GradientBoostingClassifier",
     {"n_estimators": 10, "max_depth": 3}),
    ("sklearn.naive_bayes", "GaussianNB", {}),
    ("sklearn.neighbors", "KNeighborsClassifier", {"n_neighbors": 5}),
])
def test_classifiers_learn_blobs(blobs, module, cls, kwargs):
    x, y = blobs
    model = registry.resolve(module, cls)(**kwargs, device="cpu").fit(x, y)
    assert model.score(x, y) >= 0.9
    assert set(np.unique(model.predict(x))) <= set(np.unique(y))


def test_predict_proba_shape(blobs):
    x, y = blobs
    probs = _np(registry.resolve("sklearn.naive_bayes", "GaussianNB")(
        device="cpu").fit(x, y).predict_proba(x))
    assert probs.shape == (len(x), 3)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)


def test_linear_regression_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    y = x @ w + 0.7
    lr = registry.resolve("sklearn.linear_model", "LinearRegression")(
        device="cpu").fit(x, y)
    np.testing.assert_allclose(_np(lr.coef_), w, atol=1e-3)
    assert abs(float(lr.intercept_) - 0.7) < 1e-3
    assert lr.score(x, y) > 0.999


def test_rank_deficient_least_squares_is_the_minimum_norm_solution():
    """Collinear one-hot columns plus the bias (Covertype's wilderness
    and soil blocks): lstsq's SVD cut gives jnp.linalg.lstsq's answer."""
    rng = np.random.default_rng(3)
    cat = rng.integers(0, 3, 150)
    x = np.concatenate([np.eye(3)[cat], rng.normal(size=(150, 2))],
                       1).astype(np.float32)
    y = (2.0 * cat + x[:, 3]).astype(np.float32)
    jest = jax_registry.resolve("sklearn.linear_model",
                                "LinearRegression")().fit(x, y)
    pest = registry.resolve("sklearn.linear_model", "LinearRegression")(
        device="cpu").fit(x, y)
    np.testing.assert_allclose(_np(pest.coef_), _np(jest.coef_), atol=1e-4)
    np.testing.assert_allclose(_np(pest.predict(x)), _np(jest.predict(x)),
                               atol=1e-4)


def test_kmeans_recovers_clusters(blobs):
    x, y = blobs
    labels = registry.resolve("sklearn.cluster", "KMeans")(
        n_clusters=3, max_iter=50, device="cpu").fit(x).predict(x)
    purity = sum(np.bincount(y[labels == c]).max()
                 for c in range(3) if (labels == c).any()) / len(y)
    assert purity > 0.9


def test_pca_orthogonal_components(blobs):
    x, _ = blobs
    pca = registry.resolve("sklearn.decomposition", "PCA")(
        n_components=2, device="cpu")
    assert tuple(pca.fit_transform(x).shape) == (len(x), 2)
    comps = _np(pca.components_)
    np.testing.assert_allclose(comps @ comps.T, np.eye(2), atol=1e-4)


def test_scalers(blobs):
    x, _ = blobs
    z = _np(registry.resolve("sklearn.preprocessing", "StandardScaler")(
        device="cpu").fit_transform(x))
    np.testing.assert_allclose(z.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(z.std(0), 1.0, atol=1e-3)
    z2 = _np(registry.resolve("sklearn.preprocessing", "MinMaxScaler")(
        device="cpu").fit_transform(x))
    assert z2.min() >= -1e-6 and z2.max() <= 1 + 1e-6


def _two_blobs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = np.vstack([rng.normal((-2, -2), 0.8, (n // 2, 2)),
                   rng.normal((2, 2), 0.8, (n // 2, 2))]).astype(np.float32)
    return x, np.array([0] * (n // 2) + [1] * (n // 2))


def test_svc_rbf_separates_rings():
    rng = np.random.default_rng(1)
    theta = rng.uniform(0, 2 * np.pi, 300)
    r = np.where(np.arange(300) % 2 == 0, 1.0, 3.0) + rng.normal(0, .15, 300)
    x = np.stack([r * np.cos(theta), r * np.sin(theta)], 1).astype(
        np.float32)
    y = np.arange(300) % 2
    svc = registry.resolve("sklearn.svm", "SVC")
    rbf = svc(C=5.0, max_iter=500, device="cpu").fit(x, y)
    lin = svc(kernel="linear", device="cpu").fit(x, y)
    assert rbf.score(x, y) > 0.9
    assert rbf.score(x, y) > lin.score(x, y) + 0.2


@pytest.mark.parametrize("labels", ["ints", "strings"])
def test_linear_svc_labels_and_score(labels):
    x, y = _two_blobs()
    if labels == "strings":
        y = np.where(y == 0, "neg", "pos")
    clf = registry.resolve("sklearn.svm", "LinearSVC")(device="cpu").fit(
        x, y)
    assert set(clf.predict(x)) <= set(y)
    assert clf.score(x, y) > 0.97


# -- persistence --------------------------------------------------------------


@pytest.mark.parametrize("cls", ["RandomForestClassifier", "SVC",
                                 "StandardScaler"])
def test_volume_round_trip_holds_cpu_tensors(cls, tmp_path, blobs):
    x, y = blobs
    mod = {"RandomForestClassifier": "sklearn.ensemble", "SVC": "sklearn.svm",
           "StandardScaler": "sklearn.preprocessing"}[cls]
    est = registry.resolve(mod, cls)(device="cpu").fit(x, y)
    vols = VolumeStorage(tmp_path)
    path = vols.save_estimator("train/scikitlearn", "est", est)
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    devices = set()
    convert_seen = []

    def seen(t):
        devices.add(t.device.type)
        convert_seen.append(t)
        return t

    from learningorchestra_tpu_torch.toolkit.base import map_tensors

    map_tensors(vars(raw), seen)
    assert convert_seen and devices == {"cpu"}
    loaded = vols.load_estimator("train/scikitlearn", "est", device="cpu")
    assert type(loaded) is type(est) and loaded.device.type == "cpu"
    answer = "transform" if cls == "StandardScaler" else "predict"
    np.testing.assert_array_equal(_np(getattr(loaded, answer)(x)),
                                  _np(getattr(est, answer)(x)))
