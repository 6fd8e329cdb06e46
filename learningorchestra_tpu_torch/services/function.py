"""Function service: the arbitrary-code escape hatch — port of
``learningorchestra_tpu/services/function.py``.

``POST /function/python`` runs a Python function body with its
DSL-resolved ``functionParameters`` as globals; the code must set
``response``, which is pickled to the volume (``$name`` loads it,
``$name.0`` indexes it) and stored, JSON-safe, beside what the code
printed (``functionMessage``).  The code runs in the service process,
the reference's trust model.  A function given by an ``http(s)://`` URL
is fetched when its job runs (services/dataset.py's ``open_url``).
"""

from __future__ import annotations

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.log import capture_thread_stdout
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.services.dataset import is_http, open_url
from learningorchestra_tpu_torch.services.executor import _json_safe

FUNCTION_TYPE = "function/python"


def _check_code(function) -> None:
    if not function or not isinstance(function, str):
        raise ValidationError("missing 'function' code")


def _fetch_code(function: str) -> str:
    """Inline code, or the body of the URL it names."""
    if not is_http(function):
        return function
    with open_url(function) as resp:
        return resp.read().decode()


class FunctionService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def create(self, name: str, *, function: str,
               function_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        self.ctx.require_new_name(name)
        _check_code(function)
        meta = self.ctx.artifacts.metadata.create(
            name, FUNCTION_TYPE, extra={"description": description}
        )
        self._submit(name, function, function_parameters, description,
                     deadline_s=deadline_s)
        return meta

    def update(self, name: str, *, function: str,
               function_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        self.ctx.require_existing(name)
        _check_code(function)
        self.ctx.artifacts.metadata.restart(name)
        self._submit(name, function, function_parameters, description,
                     deadline_s=deadline_s)
        return self.ctx.artifacts.metadata.read(name)

    def _submit(self, name, function, function_parameters, description,
                *, deadline_s=None):
        ctx = self.ctx

        def run():
            code = _fetch_code(function)
            params = dsl.resolve_params(function_parameters, ctx.loader)
            globs: dict = {"__name__": f"function_{name}", **params}
            # Thread-scoped: concurrent jobs' prints stay out of this
            # job's message.
            with capture_thread_stdout() as buf:
                exec(code, globs)  # noqa: S102 — the escape hatch
            if "response" not in globs:
                raise ValidationError(
                    "function code must set a 'response' variable")
            response = globs["response"]
            ctx.volumes.save_object(FUNCTION_TYPE, name, response)
            ctx.documents.insert_one(name, {
                "result": _json_safe(response),
                "functionMessage": buf.getvalue(),
            })
            return response

        # Arbitrary code is the most hang-prone surface: the per-submit
        # deadline applies (None inherits the engine default).
        ctx.engine.submit(
            name, run, description=description or "python function",
            capture_stdout=False,
            job_class="function",
            deadline_s=deadline_s,
        )

    def delete(self, name: str) -> None:
        self.ctx.delete_artifact(name)
