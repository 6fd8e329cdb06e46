"""Builder service: whole-pipeline execution — port of
``learningorchestra_tpu/services/builder.py``.

One POST runs modeling code to produce train/test features, then fits up
to five classifiers concurrently on the context's device, scores each
(F1, accuracy, fitTime) and stores per-row predictions: one artifact per
classifier, named ``{test_dataset}{classifier}``, driven by a hidden
coordinator job ``{test_dataset}__builder_run``.

The modeling code sees the datasets as :class:`~learningorchestra_tpu_
torch.services.frame.Frame`\\ s where the JAX package hands it pandas
DataFrames: column selection (``df["col"]``), ``to_numpy()``,
``columns``, ``len`` and numpy work the same on both; other pandas
methods exist only on the JAX server (ROADMAP C).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry

BUILDER_TYPE = "builder/sparkml"

# Classifier whitelist (the reference's MLlib names) -> the estimators.
CLASSIFIERS = {
    "LogisticRegression": ("sklearn.linear_model", "LogisticRegression"),
    "DecisionTree": ("sklearn.tree", "DecisionTreeClassifier"),
    "RandomForest": ("sklearn.ensemble", "RandomForestClassifier"),
    "GradientBoosting": (
        "sklearn.ensemble", "GradientBoostingClassifier",
    ),
    "NaiveBayes": ("sklearn.naive_bayes", "GaussianNB"),
}


def _f1_macro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 (the reference records MLlib's F1)."""
    classes = np.unique(np.concatenate([y_true, y_pred]))
    f1s = []
    for c in classes:
        tp = float(((y_pred == c) & (y_true == c)).sum())
        fp = float(((y_pred == c) & (y_true != c)).sum())
        fn = float(((y_pred != c) & (y_true == c)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))


def _tolist(arr: np.ndarray) -> list:
    return [v.item() if isinstance(v, np.generic) else v
            for v in arr.tolist()]


class BuilderService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def create(
        self,
        *,
        training_dataset: str,
        test_dataset: str,
        classifiers: list[str],
        label_field: str = "label",
        feature_fields: list[str] | None = None,
        modeling_code: str | None = None,
        classifier_parameters: dict | None = None,
        description: str = "",
    ) -> list[dict]:
        ctx = self.ctx
        ctx.require_finished_parent(training_dataset)
        ctx.require_finished_parent(test_dataset)
        if not classifiers:
            raise ValidationError(
                f"classifiersList must name at least one of "
                f"{sorted(CLASSIFIERS)}"
            )
        unknown = [c for c in classifiers if c not in CLASSIFIERS]
        if unknown:
            raise ValidationError(
                f"unknown classifiers: {unknown}; "
                f"allowed: {sorted(CLASSIFIERS)}"
            )
        metas = []
        for clf in classifiers:
            # A stale result of the same name is replaced, so a re-POST
            # works.
            result_name = f"{test_dataset}{clf}"
            if ctx.artifacts.metadata.exists(result_name):
                ctx.artifacts.delete(result_name)
                ctx.volumes.delete_everywhere(result_name)
            metas.append(ctx.artifacts.metadata.create(
                result_name, BUILDER_TYPE, parent_name=test_dataset,
                extra={"classifier": clf},
            ))

        def prepare():
            train_df = ctx.loader.load_frame(training_dataset)
            test_df = ctx.loader.load_frame(test_dataset)
            if modeling_code:
                globs: dict = {
                    "training_df": train_df,
                    "testing_df": test_df,
                    "np": np,
                }
                exec(modeling_code, globs)  # noqa: S102 — builder parity
                feats_train = np.asarray(globs["features_training"])
                feats_test = np.asarray(globs["features_testing"])
                # Labels from the modeling code, else the datasets' label
                # column (the reference's shape sets features_* only).
                y_train = np.asarray(
                    globs["labels_training"] if "labels_training" in globs
                    else train_df[label_field].to_numpy()).reshape(-1)
                y_test = np.asarray(
                    globs["labels_testing"] if "labels_testing" in globs
                    else test_df[label_field].to_numpy()).reshape(-1)
            else:
                cols = feature_fields or [
                    c for c in train_df.columns if c != label_field
                ]

                def features(df):
                    return np.stack([df[c].to_numpy() for c in cols],
                                    axis=1).astype(np.float32)

                feats_train = features(train_df)
                y_train = train_df[label_field].to_numpy()
                feats_test = features(test_df)
                y_test = test_df[label_field].to_numpy()
            return feats_train, y_train, feats_test, y_test

        def run_all():
            try:
                feats_train, y_train, feats_test, y_test = prepare()
            except BaseException as exc:
                # A pre-loop failure (dataset load, modeling code) shows
                # on every visible result artifact: clients poll those,
                # not the hidden coordinator.
                for clf in classifiers:
                    result_name = f"{test_dataset}{clf}"
                    ctx.artifacts.metadata.mark_failed(result_name,
                                                       repr(exc))
                    ctx.artifacts.ledger.record(
                        result_name, state="failed", exception=repr(exc))
                raise

            def run_one(clf: str):
                result_name = f"{test_dataset}{clf}"
                try:
                    ctx.artifacts.metadata.mark_running(result_name)
                    mod, cls = CLASSIFIERS[clf]
                    kwargs = (classifier_parameters or {}).get(clf, {})
                    model = registry.resolve(mod, cls)(
                        **kwargs, device=ctx.device)
                    t0 = time.perf_counter()
                    model.fit(feats_train, y_train)
                    fit_time = time.perf_counter() - t0
                    preds = np.asarray(model.predict(feats_test)).reshape(-1)
                    acc = float((preds == y_test).mean())
                    f1 = _f1_macro(y_test, preds)
                    ctx.documents.insert_many(result_name, (
                        {"prediction": p, "label": t}
                        for p, t in zip(_tolist(preds), _tolist(y_test))))
                    ctx.volumes.save_estimator(BUILDER_TYPE, result_name,
                                               model)
                    metrics = {"fitTime": fit_time, "accuracy": acc,
                               "F1": f1}
                    ctx.artifacts.metadata.mark_finished(result_name,
                                                         metrics)
                    ctx.artifacts.ledger.record(
                        result_name, description=description,
                        state="finished", metrics=metrics)
                except Exception as exc:  # noqa: BLE001 — one
                    # classifier's failure is its artifact's, the others
                    # run on.
                    ctx.artifacts.metadata.mark_failed(result_name,
                                                       repr(exc))
                    ctx.artifacts.ledger.record(
                        result_name, state="failed", exception=repr(exc))

            # The five fits run at once, on one card as on several.
            with ThreadPoolExecutor(max_workers=len(classifiers)) as pool:
                list(pool.map(run_one, classifiers))

        # One coordinating job; each classifier's state lives in its
        # result artifact's metadata.
        coordinator = f"{test_dataset}__builder_run"
        if ctx.artifacts.metadata.exists(coordinator):
            ctx.artifacts.delete(coordinator)
        ctx.artifacts.metadata.create(
            coordinator, BUILDER_TYPE,
            extra={"classifiers": classifiers, "hidden": True},
        )
        ctx.engine.submit(
            coordinator, run_all, description=description or "builder run",
            job_class="builder",
        )
        return metas
