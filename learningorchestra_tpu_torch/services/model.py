"""Model service — port of ``learningorchestra_tpu/services/model.py``.

``POST /model/<tool>`` validates ``{modulePath, class, classParameters}``
against the registry, instantiates the class inside the async job on the
context's device, under a device lease (``classParameters`` never carry
a device), and persists the instance as an estimator artifact; ``PATCH``
re-instantiates with new parameters; ``DELETE`` removes collection and
binary.
"""

from __future__ import annotations

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry


class ModelService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def _validate(self, module_path, class_name, class_parameters):
        factory = registry.resolve(module_path, class_name)  # RegistryError
        bad = registry.validate_init_params(
            module_path, class_name, class_parameters or {}
        )
        if bad:
            raise ValidationError(f"invalid classParameters: {bad}")
        return factory

    def create(
        self,
        name: str,
        *,
        module_path: str,
        class_name: str,
        class_parameters: dict | None = None,
        artifact_type: str = "model/tensorflow",
        description: str = "",
    ) -> dict:
        self.ctx.require_new_name(name)
        factory = self._validate(module_path, class_name, class_parameters)
        meta = self.ctx.artifacts.metadata.create(
            name, artifact_type, module_path=module_path,
            class_name=class_name,
        )
        self._submit(name, factory, class_parameters, artifact_type,
                     description)
        return meta

    def update(self, name: str, *, class_parameters: dict | None = None,
               description: str = "") -> dict:
        """PATCH: re-instantiate with new parameters."""
        meta = self.ctx.require_existing(name)
        factory = self._validate(
            meta.get("modulePath"), meta.get("class"), class_parameters
        )
        self.ctx.artifacts.metadata.restart(name)
        self._submit(name, factory, class_parameters, meta.get("type"),
                     description)
        return self.ctx.artifacts.metadata.read(name)

    def _submit(self, name, factory, class_parameters, artifact_type,
                description):
        ctx = self.ctx

        def run():
            # The build lands on the leased card, as the executor's jobs
            # do, and serializes with the jobs already there.
            with ctx.leaser.lease(1, label=name) as devs, placed(devs):
                params = dsl.resolve_params(class_parameters, ctx.loader)
                instance = factory(**params, device=ctx.device)
                ctx.volumes.save_estimator(artifact_type, name, instance)
            # The instance is persisted; the future keeps no device copy.
            return None

        self.ctx.engine.submit(
            name, run, description=description or f"instantiate {name}",
            parameters=class_parameters,
            job_class="model",
        )

    def delete(self, name: str) -> None:
        self.ctx.delete_artifact(name)
