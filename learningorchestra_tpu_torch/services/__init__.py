"""The pipeline's services — port of ``learningorchestra_tpu/services/``:
dataset ingest, transforms (projection, dataType cast, generic), model
creation, the train / evaluate / predict / tune executor and the
builder, each step a named, lineage-tracked, asynchronous job whose
output is persisted (store rows and volume binaries), with observe
webhooks and the event feed on its transitions."""

from learningorchestra_tpu_torch.services.builder import BuilderService
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.dataset import DatasetService
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.model import ModelService
from learningorchestra_tpu_torch.services.transform import TransformService
from learningorchestra_tpu_torch.services.webhooks import WebhookNotifier

__all__ = [
    "BuilderService",
    "DatasetService",
    "ExecutorService",
    "ModelService",
    "ServiceContext",
    "TransformService",
    "WebhookNotifier",
]
