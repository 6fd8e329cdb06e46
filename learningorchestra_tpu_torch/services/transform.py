"""Transform service: projection, dtype casting and the generic
transform — port of ``learningorchestra_tpu/services/transform.py``.

- **projection** copies the chosen columns of a finished dataset into a
  new collection on a job thread; ``PATCH`` re-runs it, replacing the
  rows;
- **dataType** casts dataset fields to number or string in place (a
  failed number cast stores ``None``), re-flagging the dataset
  unfinished while the cast runs;
- **generic** instantiates a registry class on the context's device,
  calls a method with DSL-resolved parameters and persists the result
  (tensors on the CPU); ``PATCH`` re-runs it;
- **text** BPE-tokenizes a text column of a document dataset into a
  tensor-sharded dataset of fixed-length int32 rows (and dense integer
  labels) that the streaming fit reads (``x="$name"``,
  ``y="$name.label"``); ``tokenizerFrom`` re-uses another text
  transform's tokenizer (a held-out split encoded with the train
  split's vocabulary); ``PATCH`` re-tokenizes the parent's current rows.
"""

from __future__ import annotations

import math
import shutil

import numpy as np

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.services.context import (
    DATA_ROWS,
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.services.dataset import DatasetService
from learningorchestra_tpu_torch.store.sharded import ShardedTensorWriter
from learningorchestra_tpu_torch.text.bpe import BpeTokenizer, count_words
from learningorchestra_tpu_torch.toolkit import registry

PROJECTION_TYPE = "transform/projection"
TEXT_TYPE = "transform/text"
#: Token rows (and previews) encoded per writer chunk.
_TEXT_CHUNK = 1024


def _tokenizer_volume_name(artifact_name: str) -> str:
    """The trained tokenizer's binary sits next to the artifact's shard
    directory in the transform volume, under a distinct name."""
    return artifact_name + ".tokenizer"


def _dense_labels(raw: list, label_field: str):
    """(int64 class ids, class names or None), the JAX package's rules:
    dense ints ``0..K-1`` are stored as they are; sparse or negative ints
    and strings are remapped in sorted order and their names recorded;
    a missing or NaN label is an error."""
    n_missing = sum(
        1 for v in raw
        if v is None or (isinstance(v, float) and not math.isfinite(v)))
    if n_missing:
        # A phantom "None" class would shift every class id.
        raise ValueError(
            f"{n_missing} row(s) have no {label_field!r} value; clean or "
            "project the dataset first")
    if all(isinstance(v, (int, float)) and float(v) == int(v)
           for v in raw):
        ints = [int(v) for v in raw]
        uniq = sorted(set(ints))
        if uniq == list(range(len(uniq))):
            return np.asarray(ints, np.int64), None
        # Out-of-range ids would index past the model's classes.
        lut = {c: i for i, c in enumerate(uniq)}
        return (np.asarray([lut[v] for v in ints], np.int64),
                [str(c) for c in uniq])
    classes = sorted({str(v) for v in raw})
    lut = {c: i for i, c in enumerate(classes)}
    return np.asarray([lut[str(v)] for v in raw], np.int64), classes


def _compact_best_effort(documents, name: str) -> None:
    """Fold a collection's log back to its current state.  Maintenance,
    never the job's outcome: a failed rewrite is logged and ignored."""
    try:
        documents.compact(name)
    except OSError as exc:
        get_logger("store").warning(
            "compact(%s) failed (ignored): %r", name, exc)


class TransformService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def _check_fields(self, parent: dict, fields: list[str]) -> None:
        parent_fields = parent.get("fields") or []
        missing = [f for f in fields if f not in parent_fields]
        if parent_fields and missing:
            raise ValidationError(f"fields not in parent dataset: {missing}")

    def create_projection(self, name: str, parent_name: str,
                          fields: list[str]) -> dict:
        parent = self.ctx.require_finished_parent(parent_name)
        self.ctx.require_new_name(name)
        self._check_fields(parent, fields)
        meta = self.ctx.artifacts.metadata.create(
            name, PROJECTION_TYPE, parent_name=parent_name,
            extra={"fields": fields},
        )
        self._submit_projection(name, parent_name, fields, replace=False)
        return meta

    def update_projection(self, name: str,
                          fields: list[str] | None = None) -> dict:
        """PATCH re-run: replace the projected rows, with new ``fields``
        when given, else the original request's."""
        meta = self.ctx.require_not_running(name)
        if meta.get("type") != PROJECTION_TYPE:
            raise ValidationError(f"{name!r} is not a projection")
        parent_name = meta.get("parentName")
        parent = self.ctx.require_finished_parent(parent_name)
        fields = fields or meta.get("fields") or []
        self._check_fields(parent, fields)
        self.ctx.artifacts.metadata.restart(name)
        self._submit_projection(name, parent_name, fields, replace=True)
        return self.ctx.artifacts.metadata.read(name)

    def _submit_projection(self, name: str, parent_name: str,
                           fields: list[str], *, replace: bool) -> None:
        documents = self.ctx.documents

        def project():
            if replace:
                for doc in documents.find(name, query=DATA_ROWS):
                    documents.delete_one(name, doc["_id"])
            rows = documents.find(parent_name, query=DATA_ROWS)
            n = documents.insert_many(
                name, ({f: d.get(f) for f in fields} for d in rows))
            if replace:
                # A replace wrote a delete and an insert per row.
                _compact_best_effort(documents, name)
            return {"rows": n, "fields": fields}

        self.ctx.engine.submit(
            name, project, description=f"projection of {parent_name}",
            parameters={"fields": fields},
            on_success=lambda r: r,
            job_class="transform",
        )

    # -- dtype casting --------------------------------------------------------

    def update_field_types(self, parent_name: str, fields: dict) -> dict:
        """Cast fields in place; each value is "number" or "string"."""
        meta = self.ctx.require_existing(parent_name)
        known = meta.get("fields") or []
        for field, kind in fields.items():
            if kind not in ("number", "string"):
                raise ValidationError(
                    f"field {field!r}: type must be 'number' or 'string'"
                )
            if known and field not in known:
                raise ValidationError(f"no such field: {field!r}")
        # Unfinished while the cast runs, finished again after it.
        self.ctx.artifacts.metadata.restart(parent_name)
        documents = self.ctx.documents

        def cast():
            n_updates = 0
            for doc in documents.find(parent_name, query=DATA_ROWS):
                updates = {}
                for field, kind in fields.items():
                    val = doc.get(field)
                    if val is None:
                        continue
                    if kind == "number":
                        try:
                            updates[field] = float(val)
                        except (TypeError, ValueError):
                            updates[field] = None
                    else:
                        updates[field] = str(val)
                if updates:
                    documents.update_one(parent_name, doc["_id"], updates)
                    n_updates += 1
            if n_updates:
                # The cast appended one update entry per document.
                _compact_best_effort(documents, parent_name)
            return {"cast": list(fields)}

        self.ctx.engine.submit(
            parent_name, cast, description=f"dtype cast {fields}",
            on_success=lambda r: r,
            job_class="transform",
        )
        return self.ctx.artifacts.metadata.read(parent_name)

    # -- text tokenization (BPE -> tensor-sharded int rows) -------------------

    def create_text(self, name: str, parent_name: str, *, text_field: str,
                    label_field: str | None = None, vocab_size: int = 8000,
                    max_len: int = 128, lowercase: bool = True,
                    tokenizer_from: str | None = None,
                    shard_rows: int = 4096) -> dict:
        """Tokenize ``text_field`` of a finished document dataset into a
        tensor-sharded dataset (``tokens`` (max_len,) int32 and, with
        ``label_field``, ``label``)."""
        parent = self.ctx.require_finished_parent(parent_name)
        self.ctx.require_new_name(name)
        if not text_field:
            raise ValidationError("textField is required")

        def _int(value, key):
            # A malformed value is a 406, and a non-integral float must
            # not truncate silently.
            try:
                out = int(value)
                if isinstance(value, float) and value != out:
                    raise ValueError
                return out
            except (TypeError, ValueError):
                raise ValidationError(
                    f"{key} must be an integer, got {value!r}") from None

        vocab_size = _int(vocab_size, "vocabSize")
        max_len = _int(max_len, "maxLen")
        shard_rows = _int(shard_rows, "shardRows")
        if vocab_size < 8:
            raise ValidationError(f"vocabSize too small: {vocab_size}")
        if max_len < 4:
            raise ValidationError(f"maxLen too small: {max_len}")
        if shard_rows <= 0:
            raise ValidationError("shardRows must be positive")
        self._check_text_parent(parent, text_field, label_field)
        self._check_tokenizer_from(tokenizer_from)
        meta = self.ctx.artifacts.metadata.create(
            name, TEXT_TYPE, parent_name=parent_name,
            extra={
                "textField": text_field, "labelField": label_field,
                "vocabSize": vocab_size, "maxLen": max_len,
                "lowercase": bool(lowercase),
                "tokenizerFrom": tokenizer_from,
                "shardRows": shard_rows,
            },
        )
        self._submit_text(name, meta, replace=False)
        return meta

    def _check_tokenizer_from(self, tokenizer_from) -> None:
        """A malformed or dangling ``tokenizerFrom`` is a 406."""
        if tokenizer_from is None:
            return
        if not isinstance(tokenizer_from, str) or not tokenizer_from:
            raise ValidationError(
                f"tokenizerFrom must be an artifact name, "
                f"got {tokenizer_from!r}")
        try:
            ok = self.ctx.volumes.exists(
                TEXT_TYPE, _tokenizer_volume_name(tokenizer_from))
        except ValueError:
            raise ValidationError(
                f"invalid tokenizerFrom name: {tokenizer_from!r}") from None
        if not ok:
            raise ValidationError(
                f"no trained tokenizer named {tokenizer_from!r}")

    @staticmethod
    def _check_text_parent(parent: dict, text_field: str,
                           label_field: str | None) -> None:
        """Shared by create and PATCH: the parent may have been
        re-ingested with other columns in between."""
        if parent.get("sharded"):
            raise ValidationError(
                "text tokenization reads a document dataset (sharded "
                "datasets hold numeric columns only)")
        known = parent.get("fields") or []
        for f in filter(None, (text_field, label_field)):
            if known and f not in known:
                raise ValidationError(f"no such field: {f!r}")

    def update_text(self, name: str) -> dict:
        """PATCH re-run: re-tokenize the parent's current rows with the
        original request's parameters."""
        meta = self.ctx.require_not_running(name)
        if meta.get("type") != TEXT_TYPE:
            raise ValidationError(f"{name!r} is not a text transform")
        parent = self.ctx.require_finished_parent(meta.get("parentName"))
        self._check_text_parent(parent, meta.get("textField"),
                                meta.get("labelField"))
        self._check_tokenizer_from(meta.get("tokenizerFrom"))
        self.ctx.artifacts.metadata.restart(name)
        self._submit_text(name, meta, replace=True)
        return self.ctx.artifacts.metadata.read(name)

    def _submit_text(self, name: str, meta: dict, *, replace: bool) -> None:
        ctx = self.ctx
        parent_name = meta["parentName"]
        text_field = meta["textField"]
        label_field = meta.get("labelField")
        tokenizer_from = meta.get("tokenizerFrom")
        max_len = int(meta["maxLen"])
        lowercase = bool(meta.get("lowercase", True))

        def tokenize():
            docs = ctx.documents.find(parent_name, query=DATA_ROWS)
            if not docs:
                raise ValueError(f"dataset {parent_name!r} has no rows")
            labels = classes = None
            if label_field is not None:
                labels, classes = _dense_labels(
                    [d.get(label_field) for d in docs], label_field)
            # Labels are validated before the expensive tokenizer work.
            if tokenizer_from:
                try:
                    tok = ctx.volumes.read_object(
                        TEXT_TYPE, _tokenizer_volume_name(tokenizer_from))
                except FileNotFoundError:
                    # A DELETE can land between the request and the job.
                    raise ValueError(
                        f"tokenizer {tokenizer_from!r} was deleted before "
                        "this job ran") from None
            else:
                tok = BpeTokenizer.train(
                    count_words((d.get(text_field) or "" for d in docs),
                                lowercase=lowercase),
                    vocab_size=int(meta["vocabSize"]), lowercase=lowercase)
            root = ctx.volumes.path_for(TEXT_TYPE, name)
            if replace:
                shutil.rmtree(root, ignore_errors=True)
                for doc in ctx.documents.find(name, query=DATA_ROWS):
                    ctx.documents.delete_one(name, doc["_id"])
            columns = {"tokens": (max_len,)}
            if labels is not None:
                columns["label"] = ()
            writer = ShardedTensorWriter(
                root, columns, rows_per_shard=int(meta["shardRows"]))
            preview: list[dict] = []
            for i in range(0, len(docs), _TEXT_CHUNK):
                texts = [d.get(text_field) or ""
                         for d in docs[i:i + _TEXT_CHUNK]]
                enc = tok.encode_batch(texts, max_len)
                chunk = {"tokens": enc}
                if labels is not None:
                    chunk["label"] = labels[i:i + _TEXT_CHUNK]
                writer.append_rows(chunk)
                # The first rows also land in the store: GET pages show
                # data, as a sharded CSV's preview does.
                for j in range(min(len(enc), DatasetService.PREVIEW_ROWS
                                   - len(preview))):
                    row = {"text": str(texts[j]),
                           "tokens": enc[j][enc[j] != 0].tolist()}
                    if labels is not None:
                        row["label"] = int(labels[i + j])
                    preview.append(row)
            manifest = writer.close()
            if not tokenizer_from:
                # Commit point: the shards are on disk, so the freshly
                # trained tokenizer may go live for tokenizerFrom.
                ctx.volumes.save_object(
                    TEXT_TYPE, _tokenizer_volume_name(name), tok)
            if preview:
                ctx.documents.insert_many(name, preview)
            out = {
                "fields": list(columns),
                "rows": len(docs),
                "sharded": True,
                "shards": len(manifest["shard_rows"]),
                "featureShape": [max_len],
                "vocabSize": tok.vocab_size,
                "tokenizer": tokenizer_from or name,
            }
            if classes is not None:
                out["labelClasses"] = classes
            return out

        ctx.engine.submit(
            name, tokenize,
            description=f"BPE tokenization of {parent_name}.{text_field}",
            on_success=lambda r: r,
            job_class="transform",
        )

    # -- generic transform (registry class + method) --------------------------

    def create_generic(
        self,
        name: str,
        *,
        module_path: str,
        class_name: str,
        class_parameters: dict | None = None,
        method: str | None = None,
        method_parameters: dict | None = None,
        artifact_type: str = "transform/tensorflow",
        description: str = "",
    ) -> dict:
        self.ctx.require_new_name(name)
        factory = registry.resolve(module_path, class_name)  # 406 if unknown
        bad = registry.validate_init_params(
            module_path, class_name, class_parameters or {}
        )
        if bad:
            raise ValidationError(f"invalid classParameters: {bad}")
        if method is not None:
            if not registry.validate_method(factory, method):
                raise ValidationError(f"no such method: {method!r}")
            bad = registry.validate_method_params(
                factory, method, method_parameters or {}
            )
            if bad:
                raise ValidationError(f"invalid methodParameters: {bad}")
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            module_path=module_path,
            class_name=class_name,
            method=method,
            # Persisted so a PATCH re-run rebuilds the instance without
            # the original request body.
            extra={"classParameters": class_parameters or {}},
        )
        self._submit_generic(
            name, factory, class_parameters, method, method_parameters,
            artifact_type, description, class_name,
        )
        return meta

    def update_generic(
        self,
        name: str,
        *,
        class_parameters: dict | None = None,
        method_parameters: dict | None = None,
        description: str = "",
    ) -> dict:
        """PATCH re-run with new parameters when given, else the original
        request's (class parameters from the metadata, method parameters
        from the execution ledger)."""
        meta = self.ctx.require_not_running(name)
        module_path = meta.get("modulePath")
        class_name = meta.get("class")
        if not module_path or not class_name:
            raise ValidationError(
                f"{name!r} is not a re-runnable transform execution"
            )
        factory = registry.resolve(module_path, class_name)
        if class_parameters is None:
            class_parameters = meta.get("classParameters") or {}
        if method_parameters is None:
            method_parameters = self.ctx.last_recorded_parameters(name)
        self.ctx.artifacts.metadata.restart(name)
        self._submit_generic(
            name, factory, class_parameters, meta.get("method"),
            method_parameters, meta.get("type"), description, class_name,
        )
        return self.ctx.artifacts.metadata.read(name)

    def _submit_generic(
        self, name, factory, class_parameters, method, method_parameters,
        artifact_type, description, class_name,
    ) -> None:
        ctx = self.ctx

        def run():
            # The instance and its method's work land on the leased card.
            with ctx.leaser.lease(1, label=name) as devs, placed(devs):
                instance = factory(
                    **dsl.resolve_params(class_parameters, ctx.loader),
                    device=ctx.device)
                result = instance
                if method is not None:
                    result = getattr(instance, method)(
                        **dsl.resolve_params(method_parameters, ctx.loader))
                # A neural instance persists as its artifact.
                ctx.volumes.save_estimator(artifact_type, name, result)

        ctx.engine.submit(
            name, run, description=description or f"{class_name}.{method}",
            method=method, parameters=method_parameters,
            job_class="transform",
        )
