"""Explore service: histograms, training curves and plot-producing
executions — port of ``learningorchestra_tpu/services/explore.py``.

- **histogram**: per-field value counts of a dataset, one document per
  field;
- **curves**: a train artifact's per-epoch history rows drawn as a PNG,
  loss-like series on the left scale and score-like on the right;
  ``PATCH`` re-reads the current rows (``fields`` replaces the stored
  selection);
- **plot**: a registry class built on the context's device (PCA, t-SNE,
  ...) runs a method and its (n, >=2) result is drawn as a scatter,
  coloured by ``colorBy``; ``PATCH`` re-renders.

The images are drawn by ``services/png.py`` where the JAX package uses
matplotlib: what they show (the points, their colours on a ramp, each
series' polyline) is the same, the bytes are not.
"""

from __future__ import annotations

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.services import png
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.base import as_array

HISTOGRAM_TYPE = "explore/histogram"
CURVES_TYPE = "explore/curves"
#: History keys the default curves view leaves out (bookkeeping).
_TIMING_KEYS = ("epoch_time", "samples_per_sec")


class ExploreService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    # -- histogram ------------------------------------------------------------

    def create_histogram(self, name: str, parent_name: str,
                         fields: list[str]) -> dict:
        parent = self.ctx.require_finished_parent(parent_name)
        self.ctx.require_new_name(name)
        known = parent.get("fields") or []
        missing = [f for f in fields if known and f not in known]
        if missing:
            raise ValidationError(f"fields not in parent: {missing}")
        meta = self.ctx.artifacts.metadata.create(
            name, HISTOGRAM_TYPE, parent_name=parent_name,
            extra={"fields": fields},
        )

        def run():
            for field in fields:
                counts = self.ctx.documents.aggregate_counts(parent_name,
                                                             field)
                self.ctx.documents.insert_one(name, {
                    "field": field,
                    "counts": {str(k): v for k, v in counts.items()},
                })
            return {"fields": fields}

        self.ctx.engine.submit(
            name, run, description=f"histogram of {parent_name}.{fields}",
            on_success=lambda r: r,
            job_class="explore",
        )
        return meta

    # -- training curves ------------------------------------------------------

    def create_curves(self, name: str, parent_name: str,
                      fields: list[str] | None = None) -> dict:
        """Draw a train artifact's ``docType=history`` rows."""
        self.ctx.require_finished_parent(parent_name)
        self.ctx.require_new_name(name)
        meta = self.ctx.artifacts.metadata.create(
            name, CURVES_TYPE, parent_name=parent_name,
            extra={"fields": fields},
        )
        self._submit_curves(name, parent_name, fields)
        return meta

    def update_curves(self, name: str,
                      fields: list[str] | None = None) -> dict:
        """PATCH re-run over the parent's current history rows; a new
        ``fields`` replaces the stored selection."""
        meta = self.ctx.require_not_running(name)
        if meta.get("type") != CURVES_TYPE:
            raise ValidationError(f"{name!r} is not a curves explore")
        self.ctx.require_finished_parent(meta.get("parentName"))
        if fields is None:
            fields = meta.get("fields")
        else:
            self.ctx.artifacts.metadata.update(name, {"fields": fields})
        self.ctx.artifacts.metadata.restart(name)
        self._submit_curves(name, meta["parentName"], fields)
        return self.ctx.artifacts.metadata.read(name)

    def _submit_curves(self, name, parent_name, fields) -> None:
        def run():
            rows = self.ctx.documents.find(parent_name,
                                           query={"docType": "history"})
            if not rows:
                raise ValueError(
                    f"{parent_name!r} has no history rows — train it "
                    "first (or it is not a train artifact)")
            rows.sort(key=lambda r: r.get("epoch", 0))
            series: dict[str, list] = {}
            for row in rows:
                for key, val in row.items():
                    if key in ("_id", "docType", "epoch"):
                        continue
                    if isinstance(val, (int, float)):
                        series.setdefault(key, []).append(float(val))
            if fields:
                missing = [f for f in fields if f not in series]
                if missing:
                    raise ValueError(
                        f"metrics not in history: {missing}; "
                        f"available: {sorted(series)}")
                series = {k: series[k] for k in fields}
            else:
                series = {k: v for k, v in series.items()
                          if k not in _TIMING_KEYS} or series
            png_path = self._render_curves(name, series)
            return {
                "image": str(png_path),
                "epochs": max(len(v) for v in series.values()),
                "metrics": sorted(series),
            }

        self.ctx.engine.submit(
            name, run,
            description=f"training curves of {parent_name}",
            on_success=lambda r: r,
            job_class="explore",
        )

    def _save_png(self, data: bytes, name: str, artifact_type: str):
        path = self.ctx.volumes.path_for(artifact_type, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        return path

    def _render_curves(self, name, series: dict):
        loss_like = {k: v for k, v in series.items()
                     if "loss" in k or "perplexity" in k}
        score_like = {k: v for k, v in series.items() if k not in loss_like}
        data, _ = png.curves_png(loss_like, score_like)
        return self._save_png(data, name, CURVES_TYPE)

    # -- plot-producing execution ---------------------------------------------

    def create_plot(
        self,
        name: str,
        *,
        module_path: str,
        class_name: str,
        class_parameters: dict | None = None,
        method: str = "fit_transform",
        method_parameters: dict | None = None,
        artifact_type: str = "explore/tensorflow",
        color_by: str | None = None,
        description: str = "",
    ) -> dict:
        """Run e.g. TSNE/PCA on a dataset and persist a scatter PNG."""
        self.ctx.require_new_name(name)
        factory = registry.resolve(module_path, class_name)
        if not registry.validate_method(factory, method):
            raise ValidationError(f"no such method: {method!r}")
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            module_path=module_path,
            class_name=class_name,
            method=method,
            # Persisted so a PATCH re-run re-renders without the original
            # request body.
            extra={
                "classParameters": class_parameters or {},
                "colorBy": color_by,
            },
        )
        self._submit_plot(name, factory, class_parameters, method,
                          method_parameters, artifact_type, color_by,
                          description, class_name)
        return meta

    def update_plot(
        self,
        name: str,
        *,
        class_parameters: dict | None = None,
        method_parameters: dict | None = None,
        color_by: str | None = None,
        description: str = "",
    ) -> dict:
        """PATCH re-run: re-render with new parameters when given, else
        the original request's."""
        meta = self.ctx.require_not_running(name)
        module_path = meta.get("modulePath")
        class_name = meta.get("class")
        if not module_path or not class_name:
            raise ValidationError(
                f"{name!r} is not a re-runnable explore execution")
        factory = registry.resolve(module_path, class_name)
        if class_parameters is None:
            class_parameters = meta.get("classParameters") or {}
        if method_parameters is None:
            method_parameters = self.ctx.last_recorded_parameters(name)
        if color_by is None:
            color_by = meta.get("colorBy")
        self.ctx.artifacts.metadata.restart(name)
        self._submit_plot(name, factory, class_parameters, meta.get("method"),
                          method_parameters, meta.get("type"), color_by,
                          description, class_name)
        return self.ctx.artifacts.metadata.read(name)

    def _submit_plot(self, name, factory, class_parameters, method,
                     method_parameters, artifact_type, color_by,
                     description, class_name) -> None:
        ctx = self.ctx

        def run():
            # The estimator and its method run on the leased card.
            with ctx.leaser.lease(1, label=name) as devs, placed(devs):
                instance = factory(
                    **dsl.resolve_params(class_parameters, ctx.loader),
                    device=ctx.device)
                result = as_array(getattr(instance, method)(
                    **dsl.resolve_params(method_parameters, ctx.loader)))
            colors = None
            if color_by is not None:
                colors = as_array(
                    dsl.resolve_value(color_by, ctx.loader)).reshape(-1)
            png_path = self._render_scatter(name, artifact_type, result,
                                            colors)
            return {"image": str(png_path)}

        ctx.engine.submit(
            name, run, description=description or f"{class_name} plot",
            method=method, parameters=method_parameters,
            on_success=lambda r: r,
            job_class="explore",
        )

    def _render_scatter(self, name, artifact_type, points, colors=None):
        if points.ndim != 2 or points.shape[1] < 2:
            raise ValidationError(
                "plot execution must produce (n, >=2) points")
        data, _, _ = png.scatter_png(points, colors)
        return self._save_png(data, name, artifact_type)

    def read_image(self, name: str) -> bytes:
        """The rendered PNG's bytes."""
        meta = self.ctx.require_existing(name)
        return self.ctx.volumes.read_bytes(meta.get("type", ""), name)
