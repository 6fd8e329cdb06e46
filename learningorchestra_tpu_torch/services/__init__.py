"""The pipeline's services — port of ``learningorchestra_tpu/services/``:
dataset ingest (CSV, sharded CSV, tensor, generic), transforms
(projection, dataType cast, generic, BPE text), explore (histogram,
curves, plots), model creation, the train / evaluate / predict / tune
executor, the builder and ``function/python``, each step a named, lineage-tracked, asynchronous job whose
output is persisted (store rows and volume binaries), with observe
webhooks and the event feed on its transitions."""

from learningorchestra_tpu_torch.services.builder import BuilderService
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.dataset import DatasetService
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.explore import ExploreService
from learningorchestra_tpu_torch.services.function import FunctionService
from learningorchestra_tpu_torch.services.model import ModelService
from learningorchestra_tpu_torch.services.transform import TransformService
from learningorchestra_tpu_torch.services.webhooks import WebhookNotifier

__all__ = [
    "BuilderService",
    "DatasetService",
    "ExecutorService",
    "ExploreService",
    "FunctionService",
    "ModelService",
    "ServiceContext",
    "TransformService",
    "WebhookNotifier",
]
