"""A JAX ``APIServer`` and a port ``APIServer(device="cpu")`` side by side,
driven through the JAX package's ``client.py``: the helpers the port's
REST parity tests share."""

import contextlib
import functools
import http.server
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.client import ClientError, Context
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig

#: Metadata / execution-document keys left out of the comparisons: the
#: request id and span records (minted per run on each side) and the JAX
#: package's native CSV engine's tag (not ported).
UNPORTED_KEYS = {"requestId", "trace", "engine"}


@contextlib.contextmanager
def server_pair(tmp):
    """{"jax": server, "port": server}, {"jax": client, "port": client}."""
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    servers = {
        "jax": JaxServer(jcfg),
        "port": APIServer(Config(store=StoreConfig(
            root=str(tmp / "port" / "store"),
            volume_root=str(tmp / "port" / "volumes"))), device="cpu"),
    }
    try:
        yield servers, {
            side: Context(f"http://127.0.0.1:{srv.start_background()}")
            for side, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.shutdown()


@contextlib.contextmanager
def recording(log):
    """Record (verb, path, status) of every request the client sends,
    leaving the long polls out (their count depends on timing)."""
    real = urllib.request.urlopen

    def urlopen(req, *args, **kwargs):
        path = req.full_url.split("/v1", 1)[1].split("?")[0]
        entry = [req.get_method(), path, None]
        if not path.startswith("/observe/"):
            log.append(entry)
        try:
            resp = real(req, *args, **kwargs)
        except urllib.error.HTTPError as exc:
            entry[2] = exc.code
            raise
        entry[2] = resp.status
        return resp

    urllib.request.urlopen = urlopen
    try:
        yield
    finally:
        urllib.request.urlopen = real


def status(call):
    """The HTTP status a client call got (200 when it raised nothing)."""
    try:
        call()
    except ClientError as exc:
        return exc.status
    return 200


def carry_weights(servers, model: str, x0: np.ndarray) -> None:
    """Give the JAX model binary initial params (flax has none before the
    first fit) and the port's binary the same, both in f32 compute."""
    jvols = servers["jax"].ctx.volumes
    jest = jvols.read_object("model/tensorflow", model)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x0))
    jvols.save_object("model/tensorflow", model, jest)
    pvols = servers["port"].ctx.volumes
    pest = pvols.load_estimator("model/tensorflow", model, device="cpu")
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    pest.compute_dtype = "float32"
    pvols.save_estimator("model/tensorflow", model, pest)


def data_rows(docs: list) -> list:
    """A GET page's rows without the metadata and execution documents."""
    return [d for d in docs[1:] if d.get("docType") != "execution"]


@contextlib.contextmanager
def serve_dir(root):
    """An ``http.server`` on localhost serving ``root``; yields its base
    URL (a missing file answers 404)."""

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(root)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
